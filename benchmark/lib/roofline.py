"""The least time each hand-written kernel of the port could take on one
H100 at a cell's shapes: the larger of its bytes over the HBM rate and its
operations over the peak of the units they run on (FP32 on the CUDA cores,
bf16 products on the tensor cores), summed over its launches in one
training step or serving call.

Bytes count each input read once and each output written once; operations
one multiply-add (2 FLOPs) per pixel, channel and shift. The arithmetic is
that of the kernel table in PERF.md (section 6), which it reproduces at
batch 4 (batch 8 for `scatter_rows`). Every corner engine is bounded: the
shift engine's combines, the fused engine's B4 kernels, the gather
engine's `scatter_rows`, and on each the edge-pad fold and the table
gathers. The rasterizer (B2) is not bounded: its operations depend on the
scene (the pixel-face pairs its tile lists keep).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

N_DOWN = 3
FC = 128  # the attention's projected width: the acc combine's channels
K2 = 25  # the attention's 5 x 5 window
CORNERS = 36  # the gather engine's corners a pixel: 9 offsets x 4 bilinear

# the device kernels each wrapper launches, f32 and bf16 entry points (a
# kernel that two wrappers launch is listed under both)
KERNELS = {
    "local_combine": ("combine_fwd_kernel", "combine_fwd_tc_kernel"),
    "local_combine_bwd_src": ("combine_bwd_src_kernel", "combine_bwd_src_tc_kernel"),
    "local_combine_bwd_v": ("combine_bwd_v_kernel", "combine_bwd_v_tc_kernel"),
    "attn_fused_fwd": ("conv5_kernel", "conv5_tc_kernel", "slice_sum_kernel",
                       "fwd_pixel_kernel"),
    "attn_fused_bwd_c": ("bwd_c_kernel", "bwd_c_gattn_kernel"),
    "attn_fused_bwd_a_gsrc": ("dg_kernel", "conv5_kernel", "conv5_tc_kernel",
                              "slice_sum_kernel", "fold_kernel"),
    "attn_fused_bwd_a_dw": ("dw_kernel", "dw_tc_kernel", "slice_sum_kernel"),
    "edge_pad_fold": ("fold_kernel",),
    "scatter_rows": ("row_count_kernel", "row_scan_kernel", "row_scan_totals_kernel",
                     "row_place_kernel", "segment_sort_kernel", "scatter_rows_kernel"),
    "table_gather": ("gather_kernel",),
}
UNBOUNDED = ("bin_kernel", "raster_kernel")  # B2


def attn_layers(s: int, cd: int, rep: int) -> list:
    out = [(s >> i, cd << i) for i in range(1, N_DOWN + 1)]
    return out + [out[-1]] * rep


def combine(b: int, h: int, c: int, radius: int, esize: int) -> tuple:
    """(bytes, FLOPs) of one combine launch (forward or bwd_src: the padded
    source or its gradient, the coefficient field, the output or cotangent;
    bwd_v reads the same three)."""
    k2 = (2 * radius + 1) ** 2
    hp = h + 2 * radius
    nbytes = (b * hp * hp * c + b * h * h * k2 + b * h * h * c) * esize
    return nbytes, 2.0 * b * h * h * c * k2


def fused(name: str, b: int, h: int, c: int, bf16: bool) -> tuple:
    """(bytes, FP32 FLOPs, bf16 tensor-core FLOPs) of one launch of a B4
    wrapper on a (b, h, h, c) layer: each input read once, each output
    written once (dG is an output of bwd-a-gsrc and an input of dW); the
    coefficient terms only where nonzero (4 of 49 for acc and dG, 36 of 121
    a pixel for phase C and bwd-c). Each 5x5 product is counted over the
    (h+6) x (h+6) frame of G or dG; under bf16 the gsrc projection and dW
    run as three bf16 passes (dG split into hi + mid + lo)."""
    es = 2 if bf16 else 4
    n = b * h * h
    n_halo = b * (h + 6) * (h + 6)
    fields = 4 * n * 4
    conv_halo = 2.0 * n_halo * K2 * c * FC
    if name == "attn_fused_fwd":
        nbytes = (2 * n * c + K2 * c * FC) * es + (2 * n * FC + n * K2 + FC * K2 + K2) * 4 + fields
        f32 = 2.0 * n * (4 * FC + FC * K2 + 36 * c)
        return (nbytes, f32, conv_halo) if bf16 else (nbytes, f32 + conv_halo, 0.0)
    if name == "attn_fused_bwd_c":
        return 2 * n * c * es + (n * c + 2 * n * K2) * 4 + fields, 2.0 * n * 36 * c * 2, 0.0
    if name == "attn_fused_bwd_a_gsrc":
        nbytes = K2 * c * FC * es + (n * FC + n * c + n_halo * FC) * 4 + fields
        dg = 2.0 * n * 4 * FC
        return (nbytes, dg, 3 * conv_halo) if bf16 else (nbytes, dg + conv_halo, 0.0)
    if name == "attn_fused_bwd_a_dw":
        nbytes = n * c * es + (n_halo * FC + K2 * c * FC) * 4
        return (nbytes, 0.0, 3 * conv_halo) if bf16 else (nbytes, conv_halo, 0.0)
    raise ValueError(f"unknown B4 wrapper {name!r}")


def fold(b: int, h: int, c: int, pad: int, esize: int) -> int:
    """Bytes of one edge-pad fold: the padded gradient in, the image out."""
    return (b * (h + 2 * pad) ** 2 * c + b * h * h * c) * esize


def scatter(b: int, h: int, c: int, esize: int) -> int:
    """Bytes of one `scatter_rows` launch of the gather engine's layer: the
    36 corners' gradients (B*h*h*36 rows of c) and their int64 row ids in,
    the source's gradient (B*h*h rows of c) out."""
    n = b * h * h
    return (CORNERS * n * c + n * c) * esize + CORNERS * n * 8


def gather(b: int, rows: int, attrs: int, pixels: int) -> int:
    """Bytes of one table gather: indices, the table, the rows out (f32)."""
    return b * pixels * 4 + b * rows * attrs * 4 + b * attrs * pixels * 4


def launches(cfg: dict, b: int, kind: str, f_max: int, engine: str = "shift") -> dict:
    """{wrapper: [(bytes, FP32 FLOPs, bf16 tensor-core FLOPs)] of each
    launch} of one training step ("train") or serving call ("serve") with
    the corner engine `engine` ("shift", "pallas" for the fused B4 kernels,
    or "gather"), at batch b, with f_max faces per scene (hand and object).
    Under remat of the attention a step runs each layer's forward twice."""
    bf16 = cfg["compute_dtype"] == "bfloat16"
    es = 2 if bf16 else 4
    s, train = cfg["image_size"], kind == "train"
    fwd_runs = 2 if train and cfg.get("remat") and cfg.get("remat_attn") else 1
    out: dict = {}

    def add(name, nbytes, flops):
        out.setdefault(name, []).append((nbytes, 0.0, flops) if bf16 else (nbytes, flops, 0.0))

    for h, c in attn_layers(s, cfg["conv_dim"], cfg["repeat_num"]):
        if engine == "shift":
            for radius, ch in ((3, FC), (5, c)):
                for _ in range(fwd_runs):
                    add("local_combine", *combine(b, h, ch, radius, es))
                if train:
                    add("local_combine_bwd_src", *combine(b, h, ch, radius, es))
            if train:
                add("local_combine_bwd_v", *combine(b, h, c, 5, es))
        elif engine == "pallas":
            names = ("attn_fused_fwd",) * fwd_runs + (
                ("attn_fused_bwd_c", "attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw")
                if train else ())
            for name in names:
                out.setdefault(name, []).append(fused(name, b, h, c, bf16))
        elif engine == "gather":
            if train:
                add("scatter_rows", scatter(b, h, c, es), 0.0)
        else:
            raise ValueError(f"unknown corner engine {engine!r}")
        if train:
            # the edge pads of the target (2) and, on the shift engine, of
            # the source (5)
            add("edge_pad_fold", fold(b, h, c, 2, es), 0.0)
            if engine == "shift":
                add("edge_pad_fold", fold(b, h, c, 5, es), 0.0)
    # the conditioning: the rasterizer's finish over both halves (the
    # 9 barycentric columns and 16 attributes per face), then the hand
    # atlas's barycentric warp (6 columns, the hand chart plus 2 columns)
    out["table_gather"] = [(gather(2 * b, f_max + 1, 25, s * s), 0.0, 0.0),
                           (gather(b, f_max, 6, s * (s + 2)), 0.0, 0.0)]
    return out


def bound_s(nbytes: float, f32: float, tc: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, f32 / PEAK_FP32_FLOPS + tc / PEAK_BF16_FLOPS)


def bounds(cfg: dict, b: int, kind: str, f_max: int, engine: str = "shift") -> dict:
    """{wrapper: least seconds per step or call}."""
    return {k: sum(bound_s(*x) for x in v)
            for k, v in launches(cfg, b, kind, f_max, engine).items()}
