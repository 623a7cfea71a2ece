"""The port's native image reader against cv2 on the CPU: hoig_torch.runtime's
imread (JPEG and PNG, as cv2.imread with IMREAD_COLOR), resize_linear_u8
(cv2.resize with INTER_LINEAR on uint8), the PNG decoder under
utils.util.decode_png, and dataset_base's get_affine_transform and
rodrigues, bit for bit unless a test says otherwise; the committed
fixtures against their manifest; what raises; and that no module of the
port imports cv2, PIL or torchvision (the card's machine has none)."""

import ast
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from hoig_torch import runtime
from hoig_torch.data.dataset_base import gen_trans_from_patch_cv, get_affine_transform, rodrigues
from hoig_torch.utils.util import decode_png

cv2 = pytest.importorskip("cv2")
cv2.setNumThreads(1)  # parallel test workers: one thread each

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
# (height, width): 1x1 and sizes off every MCU grid up to a ragged frame
SIZES = [(1, 1), (2, 2), (3, 5), (9, 17), (17, 9), (8, 8), (16, 16), (15, 33), (100, 101),
         (479, 641)]


def _sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def _smooth(rng, h: int, w: int, c: int = 3) -> np.ndarray:
    """Random low-frequency waves plus noise of a random strength."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, c), np.float32)
    for k in range(c):
        fx, fy, ph = rng.uniform(0.01, 0.2, 3)
        img[..., k] = 128 + 90 * np.sin(fx * xx + 7 * ph) * np.cos(fy * yy + k)
    img += rng.randn(h, w, c).astype(np.float32) * rng.uniform(0, 30)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., 0]


def _write(tmp_path, name: str, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _assert_imread_equal(tmp_path, data: bytes, name: str = "x.jpg"):
    path = _write(tmp_path, name, data)
    ref = cv2.imread(path)
    got = runtime.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_matches_manifest_and_cv2(name):
    entry = MANIFEST["files"][name]
    path = FIXTURES / name
    assert _sha(path.read_bytes()) == entry["sha256"]
    got = runtime.imread(path)
    assert list(got.shape) == entry["shape"]
    assert _sha(got.tobytes()) == entry["imread_sha256"]
    np.testing.assert_array_equal(got, cv2.imread(str(path)))


def test_fixtures_cover_the_formats():
    files = MANIFEST["files"]
    assert sum(len((FIXTURES / n).read_bytes()) for n in files) < 400 * 1024
    filters = set()
    for entry in files.values():
        filters |= set(entry.get("png_filters", []))
    assert filters == {0, 1, 2, 3, 4}  # every PNG scanline filter is read
    assert {"cv2", "libjpeg-turbo", "libpng"} <= set(MANIFEST["versions"])


@pytest.mark.parametrize("case", MANIFEST["resizes"], ids=lambda c: f"{c['source']}-{c['dsize']}")
def test_fixture_resizes_match_manifest(case):
    got = runtime.resize_linear_u8(runtime.imread(FIXTURES / case["source"]), case["dsize"])
    assert list(got.shape) == case["shape"]
    assert _sha(got.tobytes()) == case["sha256"]


# -------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("restart", [0, 2], ids=["no_restarts", "restarts"])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_matches_cv2(sampling, restart, tmp_path):
    """Random images through cv2's encoder (qualities 30-100, standard and
    optimized Huffman tables) and back: bit-equal to cv2.imread."""
    rng = np.random.RandomState(int(sampling) + restart)
    for k, (h, w) in enumerate(SIZES):
        quality = int(rng.randint(30, 101))
        opts = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                cv2.IMWRITE_JPEG_OPTIMIZE, k % 2]
        ok, buf = cv2.imencode(".jpg", _smooth(rng, h, w), opts)
        assert ok
        _assert_imread_equal(tmp_path, buf.tobytes())


def test_grey_jpeg_matches_cv2(tmp_path):
    """A grey JPEG comes back as three equal channels, as cv2 gives it."""
    rng = np.random.RandomState(1)
    for (h, w), quality in zip([(1, 1), (9, 17), (240, 320), (37, 3)], (30, 75, 95, 100)):
        ok, buf = cv2.imencode(".jpg", _smooth(rng, h, w, 1), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                               cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
        assert ok
        _assert_imread_equal(tmp_path, buf.tobytes())


def _exif_app1(orientation: int, little_endian: bool) -> bytes:
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    payload = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("little_endian", [True, False], ids=["II", "MM"])
def test_jpeg_exif_orientation_matches_cv2(little_endian, tmp_path):
    """IMREAD_COLOR turns the image by its EXIF orientation (values past
    1-8 leave it as it is)."""
    ok, buf = cv2.imencode(".jpg", _smooth(np.random.RandomState(2), 19, 30))
    data = buf.tobytes()
    shapes = set()
    for orientation in range(10):
        tagged = data[:2] + _exif_app1(orientation, little_endian) + data[2:]
        _assert_imread_equal(tmp_path, tagged)
        shapes.add(runtime.imread(_write(tmp_path, "x.jpg", tagged)).shape)
    assert shapes == {(19, 30, 3), (30, 19, 3)}


# --------------------------------------------------------------------- PNG
def _png_cases(rng):
    """(image, cv2 options) pairs that make libpng pick every filter."""
    yy, xx = np.mgrid[0:48, 0:64]
    soft = np.clip((1.3 - ((yy - 24) / 15.0) ** 2 - ((xx - 30) / 20.0) ** 2) * 400, 0, 255)
    wave = 128 + 100 * np.sin(xx * 0.13) * np.cos(yy * 0.07)
    for plane in (soft, wave, rng.randint(0, 256, (48, 64))):
        plane = plane.astype(np.uint8)
        for image in (plane, np.stack([plane, plane[::-1], 255 - plane], -1),
                      np.stack([plane, plane[::-1], plane, plane[:, ::-1]], -1)):
            for level in (None, 1, 9):
                yield image, [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level]


def test_png_matches_cv2_for_every_filter(tmp_path):
    """decode_png keeps giving RGB; imread gives cv2's BGR; 8- and 16-bit,
    gray, gray + alpha, RGB, RGBA."""
    rng = np.random.RandomState(3)
    filters = set()
    for image, opts in _png_cases(rng):
        ok, buf = cv2.imencode(".png", image, opts)
        data = buf.tobytes()
        header, _, stream = runtime._png_chunk_walk(data)
        w, h, ch = header[0], header[1], {0: 1, 2: 3, 4: 2, 6: 4}[header[3]]
        raw = zlib.decompress(stream)
        filters |= {raw[y * (w * ch + 1)] for y in range(h)}
        _assert_imread_equal(tmp_path, data, "x.png")
        ref_rgb = cv2.imread(_write(tmp_path, "x.png", data))[:, :, ::-1]
        np.testing.assert_array_equal(decode_png(data), ref_rgb)
    assert filters == {0, 1, 2, 3, 4}
    for shape in [(5, 7), (6, 9, 3), (4, 3, 4)]:
        ok, buf = cv2.imencode(".png", rng.randint(0, 2**16, shape).astype(np.uint16))
        _assert_imread_equal(tmp_path, buf.tobytes(), "x.png")  # the high byte, as cv2
        with pytest.raises(ValueError, match="bit depth 16"):
            decode_png(buf.tobytes())


def test_png_palette_and_alpha_modes(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(4)
    for mode in ("P", "LA", "RGBA", "L", "RGB"):
        im = Image.fromarray(rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)).convert(mode)
        bio = io.BytesIO()
        im.save(bio, "PNG")
        _assert_imread_equal(tmp_path, bio.getvalue(), "x.png")
        np.testing.assert_array_equal(decode_png(bio.getvalue()), np.asarray(im.convert("RGB")))


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("src_hw, dst_hw", [
    ((240, 320), (480, 640)),    # an HO3D mask at half size
    ((480, 640), (480, 640)),    # ... at full size: a copy
    ((2048, 2048), (256, 256)),  # YCB texture maps to the tables' size
    ((1024, 1024), (256, 256)),
    ((512, 512), (256, 256)),    # an exact 2x: OpenCV's INTER_AREA shortcut
    ((479, 641), (256, 256)),    # ragged
    ((37, 53), (101, 29)),
    ((34, 46), (17, 23)),
    ((1, 1), (5, 3)),
    ((5, 3), (1, 1)),
    ((17, 9), (480, 640)),
])
def test_resize_matches_cv2(src_hw, dst_hw):
    """Bit-equal on the data path's shapes and on ragged ones, 1-4 channels
    (no difference to record: the vector and scalar parts of OpenCV's
    vertical pass round alike here)."""
    rng = np.random.RandomState(src_hw[0] + dst_hw[1])
    for ch in (None, 1, 2, 3, 4):
        if ch in (2, 4) and src_hw[0] > 1000:
            continue
        shape = src_hw if ch is None else src_hw + (ch,)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        ref = cv2.resize(img, dst_hw[::-1], interpolation=cv2.INTER_LINEAR)
        got = runtime.resize_linear_u8(img, dst_hw[::-1])
        assert got.shape == ref.shape
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() == 0, (shape, int(diff.max()), int((diff > 0).sum()))


# ---------------------------------------------------- the crop and rotations
def test_affine_transform_matches_cv2(monkeypatch):
    """The crop matrix, float64 and its float32 cast, bit-equal to cv2's on
    the fabricated trees' box and on seeded random boxes, scales and
    rotations; the points are the ones the crop hands get_affine_transform."""
    from hoig_torch.data import dataset_base

    calls = []

    def recorded(src, dst):
        calls.append((np.float32(src), np.float32(dst)))
        return get_affine_transform(src, dst)

    monkeypatch.setattr(dataset_base, "get_affine_transform", recorded)
    rng = np.random.RandomState(5)
    # the HO3D tree's box (x, y, w, h) and the DexYCB tree's (x0, y0, x1, y1)
    # are the same 320 x 320 square at (80, 60)
    cases = [(240.0, 220.0, 320.0, 320.0, 1.0, 0.0)]
    cases += [(rng.uniform(0, 640), rng.uniform(0, 480), rng.uniform(10, 600),
               rng.uniform(10, 600), rng.uniform(0.5, 1.5), rng.uniform(-180, 180) * (k % 2))
              for k in range(300)]
    for cx, cy, w, h, scale, rot in cases:
        for size in (64, 256):
            for inv in (False, True):
                got = gen_trans_from_patch_cv(cx, cy, w, h, size, size, scale, rot, inv=inv)
                src, dst = calls[-1]
                ref = cv2.getAffineTransform(src, dst)
                np.testing.assert_array_equal(get_affine_transform(src, dst), ref)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, ref.astype(np.float32))
    assert len(calls) == 4 * len(cases)
    for _ in range(300):
        a = rng.uniform(-500, 900, (3, 2)).astype(np.float32)
        b = rng.uniform(0, 256, (3, 2)).astype(np.float32)
        np.testing.assert_array_equal(get_affine_transform(a, b), cv2.getAffineTransform(a, b))
    with pytest.raises(ValueError, match="collinear"):
        get_affine_transform([[0, 0], [1, 1], [2, 2]], [[0, 0], [1, 0], [0, 1]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rodrigues_matches_cv2(dtype):
    """Within one ulp of the dtype (bit-equal on this host), in cv2's dtype,
    for (3, 1), (1, 3) and (3,) vectors, the zero vector included."""
    rng = np.random.RandomState(6)
    vecs = [np.zeros((3, 1)), np.full((3,), 1e-20)]
    vecs += [rng.randn(*shape) * scale for shape in ((3, 1), (1, 3), (3,))
             for scale in (1e-9, 0.3, 1.0, 3.0) for _ in range(30)]
    for v in vecs:
        v = v.astype(dtype)
        got, ref = rodrigues(v), cv2.Rodrigues(v)[0]
        assert got.dtype == ref.dtype == dtype and got.shape == (3, 3)
        ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)).astype(dtype))
        assert np.all(np.abs(got.astype(np.float64) - ref) <= ulp), v


# ------------------------------------------------------------- what raises
def _sof_only(marker: int, precision: int = 8, ncomp: int = 3) -> bytes:
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    body = bytes([precision]) + struct.pack(">HH", 8, 8) + bytes([ncomp]) + comps
    return b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("data, match", [
    (_sof_only(0xC2), "progressive.*0xFFC2"),
    (_sof_only(0xC3), "lossless.*0xFFC3"),
    (_sof_only(0xC9), "arithmetic.*0xFFC9"),
    (_sof_only(0xC1, precision=12), "12-bit"),
    (_sof_only(0xC0, ncomp=4), "CMYK"),
], ids=["progressive", "lossless", "arithmetic", "12bit", "cmyk"])
def test_unsupported_jpeg_kinds_raise(data, match, tmp_path):
    path = _write(tmp_path, "kind.jpg", data)
    with pytest.raises(ValueError, match=match) as e:
        runtime.imread(path)
    assert path in str(e.value)


def test_broken_and_missing_files_raise(tmp_path):
    img = _smooth(np.random.RandomState(7), 64, 80)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    path = _write(tmp_path, "progressive.jpg", buf.tobytes())
    assert cv2.imread(path) is not None
    with pytest.raises(ValueError, match=r"progressive.*0xFFC2") as e:
        runtime.imread(path)
    assert path in str(e.value)

    ok, buf = cv2.imencode(".jpg", img)
    data = buf.tobytes()
    for cut in (len(data) * 3 // 5, len(data) - 2):  # mid-scan; the EOI marker alone
        path = _write(tmp_path, f"cut{cut}.jpg", data[:cut])
        # libjpeg-turbo pads a truncated stream and warns: cv2 gives an image
        assert cv2.imread(path) is not None
        with pytest.raises(ValueError, match="truncated") as e:
            runtime.imread(path)
        assert path in str(e.value)
    ok, buf = cv2.imencode(".png", img)
    path = _write(tmp_path, "cut.png", buf.tobytes()[:-30])
    with pytest.raises(ValueError, match="cut.png"):
        runtime.imread(path)

    ok, buf = cv2.imencode(".bmp", img)
    path = _write(tmp_path, "frame.bmp", buf.tobytes())
    with pytest.raises(ValueError, match="frame.bmp.*neither a JPEG nor a PNG"):
        runtime.imread(path)
    missing = str(tmp_path / "no_such_frame.jpg")
    assert cv2.imread(missing) is None
    with pytest.raises(FileNotFoundError, match="no_such_frame.jpg"):
        runtime.imread(missing)


# ------------------------------------------------------- no image libraries
_IMAGE_LIBRARIES = {"cv2", "PIL", "torchvision"}


def _imported_roots(path: Path) -> set:
    """Top-level modules a file imports: import statements, __import__ and
    importlib.import_module calls with a constant name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            if name in ("__import__", "import_module"):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_image_libraries():
    # the package and its drivers (chip_smoke.py imports an installed cv2
    # for its version alone, and blocks it while the drivers run)
    files = sorted((REPO / "hoig_torch").rglob("*.py")) + [
        REPO / name for name in ("train_torch.py", "eval_torch.py")]
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {"hoig_torch/data/hov3_dataset.py", "hoig_torch/data/ycb_dataset.py",
            "hoig_torch/data/eval_dataset.py", "hoig_torch/data/dataset_base.py",
            "hoig_torch/geometry/renderer.py", "hoig_torch/geometry/obj_io.py",
            "hoig_torch/runtime/__init__.py"} <= scanned
    for f in files:
        bad = _imported_roots(f) & _IMAGE_LIBRARIES
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
