"""The port's metric battery (hoig_torch/metrics) against PIL and against
hoig_tpu/metrics on the CPU.

The PNG decoder and the resize are bit-equal to PIL (the JAX package's
loader); SSIM, MS-SSIM, the Fréchet distance, the FID Inception's pool3
features and LPIPS agree with the JAX package's within the bounds stated
at each test, on weights carried across by hoig_torch.models.convert; the
path APIs agree on a four-image tree, and scripts/parity_eval_torch.py runs
end to end on a tiny synthetic run.
"""

import importlib
import io
import os
import struct
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hoig_torch.metrics.inception import FIDInceptionV3, load_torch_weights, resize_bilinear
from hoig_torch.models.convert import inception_state_dict_from_flax, lpips_state_dict_from_flax
from hoig_torch.utils.util import decode_png, encode_png

# the packages export functions named like their modules (ssim): import the modules by name
tfid, tloader, tlpips, tssim = (importlib.import_module(f"hoig_torch.metrics.{m}")
                                for m in ("fid", "image_loader", "lpips", "ssim"))
jfid, jloader, jinception, jlpips, jssim = (
    importlib.import_module(f"hoig_tpu.metrics.{m}")
    for m in ("fid", "image_loader", "inception", "lpips", "ssim"))

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _smooth_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A photo-like RGB image: gradients and ripples plus noise, so that
    PIL's encoder picks several scanline filters."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 0.7 + y * 0.3) % 256, np.sin(x / 9.0) * 60 + 120 + rng.randint(0, 20, (h, w)),
                    (y * 1.1 + rng.randint(0, 6, (h, w))) % 256], -1)
    return img.astype(np.uint8)


def _filter_line(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> bytes:
    """PNG scanline filter `kind` applied to one line (the encoder's side)."""
    x, b = line.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _png(pixels: np.ndarray, ctype: int, filters, palette=None, depth: int = 8,
         interlace: int = 0) -> bytes:
    """An 8-bit PNG of color type `ctype` whose line y uses filters[y % len]."""
    h, w = pixels.shape[:2]
    bpp = _CHANNELS[ctype]
    rows = pixels.reshape(h, w * bpp)
    prev = np.zeros(w * bpp, np.uint8)
    raw = b""
    for y in range(h):
        raw += _filter_line(filters[y % len(filters)], rows[y], prev, bpp)
        prev = rows[y]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"tEXt", b"k\x00v")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _pixels(ctype: int, h: int = 13, w: int = 17):
    rng = np.random.RandomState(ctype)
    if ctype == 3:
        return rng.randint(0, 256, (h, w, 1)), rng.randint(0, 256, (256, 3))
    return rng.randint(0, 256, (h, w, _CHANNELS[ctype])), None


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decoder_matches_pil_per_filter(ctype, filt):
    pixels, palette = _pixels(ctype)
    data = _png(pixels.astype(np.uint8), ctype, [filt], palette)
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_png_decoder_matches_pil_with_filters_mixed_per_line():
    for ctype in _CHANNELS:
        pixels, palette = _pixels(ctype, 29, 31)
        data = _png(pixels.astype(np.uint8), ctype, [4, 0, 3, 1, 2, 4, 3], palette)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def _scanline_filters(data: bytes) -> set:
    pos, idat, w, h, ch = 8, b"", 0, 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
            ch = _CHANNELS[ctype]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (w * ch + 1)] for y in range(h)}


@pytest.mark.parametrize("mode", ["RGB", "L", "LA", "RGBA", "P"])
def test_png_decoder_matches_pil_on_files_pil_saved(mode):
    im = Image.fromarray(_smooth_image(64, 80))
    im = im.convert("P", palette=Image.ADAPTIVE, colors=256) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = buf.getvalue()
    if mode in ("RGB", "RGBA"):
        assert len(_scanline_filters(data)) >= 3  # PIL chose filters line by line
    np.testing.assert_array_equal(decode_png(data), _pil_rgb(data))


def test_png_decoder_reads_the_port_encoder():
    img = _smooth_image(33, 21, seed=3)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(_pil_rgb(data), img)


def _bad_crc():
    data = bytearray(_png(np.zeros((4, 4, 3), np.uint8), 2, [0]))
    data[-20] ^= 1  # a byte of the IDAT payload
    return bytes(data)


@pytest.mark.parametrize("make,match", [
    (lambda: _png(np.zeros((4, 4, 3), np.uint8), 2, [0], depth=16), "bit depth 16"),
    (lambda: _png(np.zeros((4, 4, 3), np.uint8), 2, [0], interlace=1), "interlace 1"),
    (_bad_crc, "CRC"),
    (lambda: _png(np.full((4, 4, 1), 9, np.uint8), 3, [0], np.zeros((4, 3))), "palette index 9"),
    (lambda: b"GIF89a" + bytes(20), "not a PNG"),
], ids=["16bit", "interlaced", "crc", "palette_index", "not_png"])
def test_png_decoder_refuses_what_it_does_not_read(make, match):
    with pytest.raises(ValueError, match=match):
        decode_png(make())


@pytest.mark.parametrize("src,dst", [((256, 256), (299, 299)), ((64, 64), (299, 299)),
                                     ((320, 320), (256, 256)), ((70, 45), (31, 90))])
def test_resize_is_bit_equal_to_pil_bilinear(src, dst):
    img = _smooth_image(src[1], src[0], seed=src[0])
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    np.testing.assert_array_equal(tloader.pil_bilinear_resize(img, dst), want)


@pytest.mark.parametrize("norm", ["imagenet", "uint8", "half"])
def test_load_eval_image_is_bit_equal_to_jax(norm, tmp_path):
    path = tmp_path / "a.png"
    Image.fromarray(_smooth_image(96, 96)).save(path)
    kw = dict(imagenet_normalize=norm == "imagenet", as_uint8_range=norm == "uint8")
    want = jloader.load_eval_image(str(path), 64, **kw)
    got = tloader.load_eval_image(str(path), 64, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,size", [("ssim", 64), ("ms_ssim", 180)])
def test_ssim_matches_jax(fn, size):
    """Within 1e-5 (values in [0, 1]), per sample."""
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 3, size, size) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape) * 25, 0, 255).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(getattr(jssim, fn)(jnp.asarray(x), jnp.asarray(y), size_average=False))
    got = getattr(tssim, fn)(torch.from_numpy(x), torch.from_numpy(y), size_average=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert float(getattr(tssim, fn)(torch.from_numpy(x), torch.from_numpy(x))) == pytest.approx(
        1.0, abs=1e-5)


def test_frechet_distance_matches_jax():
    """Within 1e-6 relative on the same statistics (the same scipy sqrtm)."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(200, 16), rng.randn(200, 16) * 1.3 + 0.4
    stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    want = jfid.calculate_frechet_distance(*stats)
    assert tfid.calculate_frechet_distance(*stats) == pytest.approx(want, rel=1e-6)
    assert tfid.calculate_frechet_distance(*stats[:2], *stats[:2]) == pytest.approx(0, abs=1e-6)


def _zero_variables(module, *args) -> dict:
    """The module's variables as zeros, shaped without running its init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _fake_inception_state(params, seed=0) -> dict:
    """A pytorch-fid-style state dict shaped after the flax tree, with
    running statistics and scales away from their defaults."""
    rng = np.random.RandomState(seed)
    state = {}

    def walk(node, prefix):
        for k, v in node.items():
            if k == "conv":
                kern = np.asarray(v["kernel"])
                fan_in = np.prod(kern.shape[:3])
                state[f"{prefix}.conv.weight"] = (rng.randn(*kern.transpose(3, 2, 0, 1).shape)
                                                  * np.sqrt(2.0 / fan_in)).astype(np.float32)
            elif k == "bn":
                c = np.asarray(v["scale"]).shape[0]
                state[f"{prefix}.bn.weight"] = (rng.rand(c) + 0.5).astype(np.float32)
                state[f"{prefix}.bn.bias"] = (rng.randn(c) * 0.1).astype(np.float32)
                state[f"{prefix}.bn.running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
                state[f"{prefix}.bn.running_var"] = (rng.rand(c) + 0.5).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, f"{prefix}.{k}" if prefix else k)

    walk(params["params"], "")
    state["fc.weight"] = np.zeros((1008, 2048), np.float32)  # pytorch-fid's head, unused
    return state


@pytest.mark.parametrize("size", [75, 107])
def test_inception_pool3_matches_jax(size):
    """resize_input=False at 75 and 107 px: within 1e-4 of the largest
    activation; the JAX weights (load_torch_weights of a fabricated
    pytorch-fid state dict) carried over by inception_state_dict_from_flax
    equal that state dict loaded directly."""
    jmodel = jinception.FIDInceptionV3(resize_input=False)
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    params = _zero_variables(jmodel, jnp.zeros((1, size, size, 3)))
    state = _fake_inception_state(params)
    jparams = jinception.load_torch_weights(params, state)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    model = load_torch_weights(FIDInceptionV3(resize_input=False), state).eval()
    carried = inception_state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    own = model.state_dict()
    assert set(carried) == {k for k in own if not k.endswith("num_batches_tracked")}
    for k, v in carried.items():
        assert torch.equal(v, own[k]), k
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("src,dst", [(64, 299), (256, 299), (320, 299), (299, 75), (296, 299)],
                         ids=["up64", "up256", "down320", "down299", "mixed"])
def test_inception_resize_matches_jax_image_resize(src, dst):
    """The input resize against jax.image.resize(..., "bilinear"), both
    directions: within 2e-5 on [0, 1] images (torch's antialiased weights
    when shrinking: 1.2e-5 at 320 -> 299 when this was written; 1.2e-7
    when enlarging)."""
    x = np.random.RandomState(src).rand(2, src, src + 5, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x.transpose(0, 3, 1, 2)), (dst, dst))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=2e-5, rtol=0)


def _fake_lpips_files(tmp_path, seed=0):
    rng = np.random.RandomState(seed)
    state_a, in_c = {}, 3
    for (c, k, _, _), ti in zip(jlpips._ALEX_CFG, jlpips._ALEX_TORCH_IDX):
        state_a[f"features.{ti}.weight"] = (rng.randn(c, in_c, k, k)
                                            * np.sqrt(2.0 / (in_c * k * k))).astype(np.float32)
        state_a[f"features.{ti}.bias"] = (rng.randn(c) * 0.05).astype(np.float32)
        in_c = c
    state_a["classifier.1.weight"] = np.zeros((4, 4), np.float32)  # torchvision's, unused
    state_l = {f"lpips_weights.{i}.main.1.weight": np.abs(rng.randn(1, c, 1, 1)).astype(np.float32)
               for i, (c, *_) in enumerate(jlpips._ALEX_CFG)}
    fa, fl = str(tmp_path / "alexnet.npz"), str(tmp_path / "lpips.npz")
    np.savez(fa, **state_a)
    np.savez(fl, **state_l)
    return fa, fl


def test_lpips_matches_jax(tmp_path):
    """Fabricated AlexNet and lpips weights through both packages'
    load_weights: within 1e-5 relative; lpips_state_dict_from_flax of the
    JAX parameters equals the port's loaded state dict."""
    fa, fl = _fake_lpips_files(tmp_path)
    rng = np.random.RandomState(4)
    x, y = (rng.rand(2, 2, 96, 96, 3).astype(np.float32) * 2 - 1)
    jmodel = jlpips.LPIPSNet()
    params = jlpips.load_weights(_zero_variables(jmodel, jnp.asarray(x), jnp.asarray(y)), fa, fl)
    with jax.default_matmul_precision("highest"):
        want = float(jmodel.apply(params, jnp.asarray(x), jnp.asarray(y)))
    model = tlpips.load_weights(tlpips.LPIPSNet(), fa, fl).eval()
    carried = lpips_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert carried.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(carried[k], v), k
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = float(model(nchw(x), nchw(y)))
        assert float(model(nchw(x), nchw(x))) == pytest.approx(0.0, abs=1e-6)
    assert got == pytest.approx(want, rel=1e-5)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Four 64 px image pairs, written by PIL (adaptive filters) and by the
    port's encoder, and fabricated metric weights."""
    root = tmp_path_factory.mktemp("tree")
    for sub in ("imitators", "gt"):
        (root / sub).mkdir()
    for i in range(4):
        img = _smooth_image(64, 64, seed=i)
        noisy = np.clip(img.astype(np.int16) + np.random.RandomState(10 + i).randint(
            -40, 40, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / "gt" / f"{i}.png")
        (root / "imitators" / f"{i}.png").write_bytes(encode_png(noisy))
    jparams = _zero_variables(jinception.FIDInceptionV3(), jnp.zeros((1, 75, 75, 3)))
    inception = str(root / "inception.npz")
    np.savez(inception, **_fake_inception_state(jparams, seed=1))
    return root, inception, _fake_lpips_files(root, seed=1)


def test_fid_given_paths_matches_jax(tree, capsys):
    """Four images a side (covariances of rank 3), the port through its
    CLI: within 1e-3 relative. (Each Fréchet distance takes a 2048 x 2048
    sqrtm, about 10 s here: a tree against itself is checked on the card,
    by chip_smoke.py.)"""
    root, inception, _ = tree
    pair = [str(root / "imitators"), str(root / "gt")]
    with jax.default_matmul_precision("highest"):
        want = jfid.calculate_fid_given_paths(pair, batch_size=4, weights_path=inception)
    got = tfid.main(pair + ["--batch-size", "4", "--weights", inception, "--device", "cpu"])
    assert f"FID:  {got}" in capsys.readouterr().out
    assert got == pytest.approx(want, rel=1e-3)


def test_lpips_and_ssim_given_paths_match_jax(tree, capsys):
    """LPIPS within 1e-5 relative, SSIM and MS-SSIM within 1e-5; the CLIs
    print the same values."""
    root, _, (fa, fl) = tree
    pair = [str(root / "imitators"), str(root / "gt")]
    with jax.default_matmul_precision("highest"):
        want_l = jlpips.calculate_lpips_given_paths(pair, 64, 2, fa, fl)
        want_s = jssim.calculate_ssim_given_paths(pair, 64, 2)
    got_l = tlpips.calculate_lpips_given_paths(pair, 64, 2, fa, fl, device="cpu")
    got_s = tssim.calculate_ssim_given_paths(pair, 64, 2, device="cpu")
    assert got_l == pytest.approx(want_l, rel=1e-5)
    np.testing.assert_allclose(got_s, want_s, atol=1e-5, rtol=0)
    capsys.readouterr()
    tssim.main(pair + ["64", "--device", "cpu"])
    tlpips.main(pair + ["--img_size", "64", "--alexnet", fa, "--lpips_weights", fl,
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "SSIM: " in out and "MS-SSIM: " in out
    assert abs(float(out.strip().splitlines()[-1]) - got_l) <= 1e-5 * abs(got_l)


def test_metrics_refuse_without_cuda(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    root, _, _ = tree
    with pytest.raises(RuntimeError, match="CUDA"):
        tssim.calculate_ssim_given_paths([str(root / "gt")] * 2)


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    from hoig_torch.train.trainer import TrainConfig, build_generator

    path = tmp_path_factory.mktemp("g") / "net_epoch_1_id_G.pth"
    g = build_generator(TrainConfig(image_size=64, conv_dim=8, repeat_num=2, remat=False),
                        device="cpu", seed=8)
    torch.save(g.state_dict(), path)
    return str(path)


def test_parity_eval_torch_end_to_end(port_checkpoint, tmp_path):
    """scripts/parity_eval_torch.py on a tiny synthetic run: the eval tree,
    the battery (weights missing -> flagged), the report, and the
    comparison with a reference tree generated from the same checkpoint
    (identical: every metric within 1%); a reference 10% off in SSIM fails
    the verdict."""
    sys.path.insert(0, str(REPO / "scripts"))
    import parity_eval_torch

    out, ref = str(tmp_path / "out"), str(tmp_path / "ref_tree")
    args = ["--checkpoint", port_checkpoint, "--dataset_mode", "synthetic",
            "--data_dir", str(tmp_path / "nodata"), "--output_dir", out, "--conv_dim", "8",
            "--repeat_num", "2", "--image_size", "64", "--batch_size", "2",
            "--synthetic_size", "4", "--metric_batch", "4", "--device", "cpu",
            "--eval_extra", "--no_remat --use_spade"]
    ref_args = list(args)
    ref_args[ref_args.index("--output_dir") + 1] = ref
    parity_eval_torch.generate_tree(parity_eval_torch.parse_args(ref_args))
    report = parity_eval_torch.main(args + ["--ref_tree", ref])
    for sub in ("source", "imitators", "gt"):
        assert len(os.listdir(os.path.join(out, sub))) == 4, sub
    ours = report["ours"]
    for k in ("fid", "lpips", "ssim", "ms_ssim"):
        assert np.isfinite(ours[k]), k
    assert set(ours["weights_missing"]) == {"inception", "alexnet", "lpips"}
    assert 0.0 < ours["ssim"] <= 1.0
    assert os.path.exists(os.path.join(out, "parity_report.json"))
    assert report["parity"]["all_within_1pct"] is True
    for k in ("fid", "lpips", "ssim", "ms_ssim"):
        assert report["parity"][k]["rel_delta"] == pytest.approx(0.0, abs=1e-9)
    worse = dict(ours, ssim=ours["ssim"] * 0.9)
    assert parity_eval_torch.compare(worse, report["reference"])["all_within_1pct"] is False
