"""Name-by-name coverage of the port: every public function and class defined
at the top of a hoig_tpu module has a function or class of the same name in
the hoig_torch module at the same path. Both packages are read with `ast`;
neither is imported. An alias (`a = b`) or an import does not count: the
name must be defined where the JAX package defines it.

The exceptions below are the JAX package's TPU, XLA and flax machinery. Each
names the port's counterpart, which must exist, or says why there is none;
an exception that no longer excuses anything fails the test.

The JAX package's scripts (the Python files at the root and under scripts/
that are not the port's: `*_torch.py` and chip_smoke.py) are matched the
same way, by file: each has its `_torch` counterpart beside it or a named
exception."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "hoig_tpu", ROOT / "hoig_torch"

# whole modules: JAX module -> the port's module that takes its place (None:
# no counterpart)
MODULE_EXCEPTIONS = {
    # XLA's persistent compile cache; the port compiles only its kernels,
    # cached by hoig_torch/ops/_cuda.py
    "utils/cache.py": None,
    # flax <-> torch parameter maps, both ways
    "models/torch_port.py": "models/convert.py",
    # the Pallas kernels' modules -> the CUDA kernels' wrappers
    "ops/rasterizer_pallas.py": "ops/rasterizer_cuda.py",
    "ops/attn_pallas.py": "ops/attn_fused.py",
}

# single names: (JAX module, name) -> (port module, port name), or None
NAME_EXCEPTIONS = {
    # HOIG_COMPILE_LITE swaps Pallas kernels for XLA fallbacks when the TPU
    # compile service is slow; nothing compiles at run time in the port
    ("ops/__init__.py", "compile_lite"): None,
    # the TPU's one-hot MXU form of the exact row gather
    ("ops/table_gather.py", "gather_rows_mxu"): ("ops/table_gather.py", "gather_rows"),
    # a jax.sharding mesh; the port averages gradients over torch.distributed
    ("parallel/mesh.py", "make_data_mesh"): ("parallel/mesh.py", "DataParallel"),
    # flax msgpack trees; the port writes torch.save and reads flax msgpack
    ("train/checkpoints.py", "save_tree"): ("train/checkpoints.py", "save_checkpoint"),
    ("train/checkpoints.py", "load_tree"): ("train/flax_ckpt.py", "read_flax_checkpoint"),
    # flax module constructors -> the port's nn.Sequential stacks and modules
    ("models/layers.py", "ConvINReLU"): ("models/layers.py", "conv_in_relu"),
    ("models/layers.py", "UpConvINReLU"): ("models/layers.py", "upconv_in_relu"),
    ("models/layers.py", "conv"): ("models/layers.py", "Conv2d"),
    ("models/layers.py", "conv_transpose"): ("models/layers.py", "ConvTranspose2d"),
    # the JAX package's process-wide compute dtype; each port module takes
    # its compute_dtype as an argument instead
    ("models/layers.py", "compute_dtype"): None,
    ("models/layers.py", "set_compute_dtype"): None,
    # flax VGG parameters from a seed / from torchvision's state dict; the
    # port's Vgg19Features is a torch module that loads that state dict as is
    ("models/vgg.py", "init_vgg_params"): ("models/vgg.py", "init_vgg"),
    ("models/vgg.py", "load_torch_weights"): ("train/model_api.py", "load_vgg_weights"),
}


def _defined(path: Path) -> set:
    """Public functions and classes defined at the module's top level."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _missing():
    """(module, name) pairs of the JAX package that the port lacks, before
    the exceptions."""
    out = []
    for rel in _jax_modules():
        port = PORT_PKG / rel
        have = _defined(port) if port.exists() else set()
        out += [(rel, name) for name in sorted(_defined(JAX_PKG / rel) - have)]
    return out


def test_every_public_name_has_its_counterpart():
    unexcused = [(rel, name) for rel, name in _missing()
                 if rel not in MODULE_EXCEPTIONS and (rel, name) not in NAME_EXCEPTIONS]
    assert not unexcused, f"hoig_torch lacks {len(unexcused)} names: {unexcused}"


@pytest.mark.parametrize("rel", sorted(MODULE_EXCEPTIONS))
def test_module_exceptions_hold(rel):
    """The module exists in the JAX package, not in the port, and its
    named replacement does."""
    assert (JAX_PKG / rel).exists() and not (PORT_PKG / rel).exists()
    if MODULE_EXCEPTIONS[rel] is not None:
        assert (PORT_PKG / MODULE_EXCEPTIONS[rel]).exists()


def test_name_exceptions_hold():
    """Each excused name is still missing from the port (else the exception
    goes), and each named counterpart exists."""
    missing = set(_missing())
    for (rel, name), counterpart in NAME_EXCEPTIONS.items():
        assert (rel, name) in missing, f"{rel}::{name} exists now: drop its exception"
        if counterpart is not None:
            prel, pname = counterpart
            assert pname in _defined(PORT_PKG / prel), counterpart


def test_the_scan_sees_what_it_should():
    """Names this scan once found missing are defined now, and the scan
    counts a module's defs (not its aliases or imports)."""
    for rel, name in (("geometry/projection.py", "look_at"),
                      ("ops/grid_sample.py", "grid_sample_packed"),
                      ("ops/rasterizer_grad.py", "render_rgb_exact"),
                      ("geometry/neural_renderer_api.py", "Renderer")):
        assert name in _defined(JAX_PKG / rel) and name in _defined(PORT_PKG / rel), (rel, name)
    assert "grid_sample" not in _defined(PORT_PKG / "geometry/renderer.py")  # imported only


# JAX package scripts -> the port's file that takes their place (None: none)
SCRIPT_EXCEPTIONS = {
    # drives the JAX package on the TPU (a dry run on a virtual mesh); the
    # smoke script drives the port on the card
    "__graft_entry__.py": "chip_smoke.py",
    # turns the torch assets into .npz for the JAX loaders; the port reads
    # the .pth files themselves (ROADMAP A1)
    "scripts/convert_weights.py": None,
}


def _jax_scripts():
    files = sorted(ROOT.glob("*.py")) + sorted((ROOT / "scripts").glob("*.py"))
    return [str(f.relative_to(ROOT)) for f in files
            if not f.stem.endswith("_torch") and f.name != "chip_smoke.py"]


def test_every_jax_script_has_its_counterpart():
    scripts = _jax_scripts()
    assert {"train.py", "eval.py", "bench.py", "scripts/profile_step.py", "scripts/attn_ab.py",
            "scripts/flops_ceiling.py", "scripts/parity_eval.py"} <= set(scripts)
    for rel in scripts:
        twin = ROOT / rel.replace(".py", "_torch.py")
        if rel in SCRIPT_EXCEPTIONS:
            assert not twin.exists(), f"{rel} has a counterpart now: drop its exception"
            if SCRIPT_EXCEPTIONS[rel] is not None:
                assert (ROOT / SCRIPT_EXCEPTIONS[rel]).exists(), SCRIPT_EXCEPTIONS[rel]
        else:
            assert twin.exists(), f"{rel} has no counterpart {twin.relative_to(ROOT)}"
