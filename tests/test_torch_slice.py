"""The serving slice end to end on the CPU: hoig_torch's flow_only +
forward_only against hoig_tpu's _flow_only + _forward_only with the same
weights and the same batch; the device policy of the entry points; and the
import boundary of the port."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoig_tpu.data import synthetic as jsyn
from hoig_tpu.geometry.conditioning import ConditioningConfig as JaxConditioningConfig
from hoig_tpu.models import NetworksFactory as JaxFactory
from hoig_tpu.train.model_api import _flow_only, _forward_only
from hoig_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hoig_tpu.train.trainer import generator_kwargs as jax_generator_kwargs
from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.geometry.mano import MANOModel
from hoig_torch.models import NetworksFactory
from hoig_torch.models.convert import generator_state_dict_from_flax
from hoig_torch.train.model_api import batch_as_torch, flow_only, forward_only
from hoig_torch.train.trainer import TrainConfig, build_generator

# parallel test workers each run torch's CPU kernels; one intra-op thread per
# worker keeps them from contending for the same cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
S, B = 64, 2
_DIMS = dict(bg_dim=8, img_dim=3, obj_dim=3, img_cond_dim=3, obj_cond_dim=12)


def _random_tree(shapes, seed):
    """flax-shaped numpy weights: kernels N(0, 0.02), norm scales
    1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        if "kernel" in name:
            return (rng.randn(*leaf.shape) * 0.02).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_serving_slice_matches_jax():
    jtables, jmano, obj_verts = jsyn.synthetic_environment(2, S)
    batch = jsyn.synthetic_batch(B, obj_verts, image_size=S)
    jcfg = JaxTrainConfig(image_size=S, conv_dim=8, repeat_num=2, remat=False,
                          corner_engine="shift")
    g = JaxFactory.get_by_name(jcfg.gen_name, **_DIMS, conv_dim=8, repeat_num=2, remat=False,
                               corner_engine="shift")
    jbatch = jax.tree.map(jnp.asarray, batch)
    frozen = dict(tables=jtables.as_jax(), mano_params=jmano.as_jax())
    with jax.default_matmul_precision("highest"):
        jflow = jax.jit(functools.partial(_flow_only, ccfg=JaxConditioningConfig(image_size=S)))(
            jbatch, frozen)
        shapes = jax.eval_shape(
            g.init, jax.random.PRNGKey(0),
            **jax_generator_kwargs(jflow, jbatch["maskA"], jbatch["maskB"], True))
        params = _random_tree(shapes, seed=11)
        ref = jax.jit(functools.partial(_forward_only, model=g, tcfg=jcfg))(params, jflow, jbatch)

    tcfg = TrainConfig(conv_dim=8, repeat_num=2, corner_engine="shift")
    gen = build_generator(tcfg, device="cpu")
    gen.load_state_dict(generator_state_dict_from_flax(params, tcfg))
    # the JAX-built tables for both: the port's own differ in the last bits
    # of wim_uv (tests/test_torch_conditioning.py)
    tables = {k: torch.as_tensor(getattr(jtables, k)) for k in (
        "faces", "face_valid", "num_faces", "map_fn", "sem", "fim_uv", "wim_uv",
        "faces_uv_coord", "obj_tex")}
    tbatch = batch_as_torch(batch, "cpu")
    flow = flow_only(tbatch, dict(tables=tables, mano_params=MANOModel.synthetic(0).as_torch("cpu")),
                     ConditioningConfig(image_size=S))
    out = forward_only(gen, flow, tbatch, tcfg)
    names = ("fake_src", "fake_tsf", "src_mask_bg", "src_mask_hand", "tsf_mask_bg",
             "tsf_mask_hand")
    for name, a, b in zip(names, out, ref):
        assert tuple(a.shape) == b.shape == (B, S, S, 3 if name.startswith("fake") else 1)
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0, err_msg=name)


def test_entry_points_default_to_cuda():
    """Without a card the entry points raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        NetworksFactory.get_by_name("generator_spade_attn", **_DIMS, conv_dim=8, repeat_num=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        MANOModel.synthetic(0).as_torch()
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.trainer import build_networks

    with pytest.raises(RuntimeError, match="CUDA"):
        build_networks(TrainConfig(conv_dim=8, repeat_num=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_vgg()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """Without a card (and alone, outside a checkout) the smoke script exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would measure it")
    import shutil
    import subprocess
    import sys

    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script), "--out", str(tmp_path / "out")],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and not (tmp_path / "out").exists()


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "hoig_tpu"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = sorted((REPO / "hoig_torch").rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "train_torch.py", "eval_torch.py",
                                 "bench_torch.py", "scripts/parity_eval_torch.py",
                                 "scripts/profile_step_torch.py", "scripts/attn_ab_torch.py",
                                 "scripts/flops_ceiling_torch.py")]
    assert len(files) > 30
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {f"hoig_torch/metrics/{m}.py" for m in ("fid", "inception", "lpips", "ssim",
                                                   "image_loader")} <= scanned
    assert {"hoig_torch/parallel/mesh.py", "hoig_torch/train/flax_ckpt.py",
            "hoig_torch/utils/flops.py"} <= scanned
    for f in files:
        bad = _imported_roots(f) & _FORBIDDEN
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
