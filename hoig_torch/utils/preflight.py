"""Preflight asset checks (port of hoig_tpu/utils/preflight.py): every
externally sourced file a real-data run needs is verified up front, and all
missing pieces are reported at once, each with where to get it.
"""

from __future__ import annotations

import os


def _check(missing: list, path: str, what: str, hint: str) -> None:
    if not path or not os.path.exists(path):
        missing.append(f"  - {what}: `{path}` not found.\n      {hint}")


def preflight_assets(opt, eval_pairs: str | None = None) -> None:
    """Verify every asset a real-data run needs; raise ONE FileNotFoundError
    listing all missing pieces. Synthetic runs need no assets."""
    if getattr(opt, "synthetic_data", False) or opt.dataset_mode == "synthetic":
        return
    missing: list = []
    is_ycb = opt.dataset_mode == "ycb"

    mano = getattr(opt, "mano_model", "")
    if not (
        os.path.isfile(mano)
        or (os.path.isdir(mano) and _has_mano_pkl(mano))
    ):
        missing.append(
            f"  - MANO model: no MANO_RIGHT*.pkl at or under `{mano}`.\n"
            "      Register at https://mano.is.tue.mpg.de, download the "
            "models, and point --mano_model at the smplx models dir "
            "(reference layout: assets/smplx/models/mano/MANO_RIGHT.pkl)."
        )

    uv = getattr(opt, "uv_mapping", "assets/MANO_UV_right.obj")
    uv = uv[0] if isinstance(uv, list) else uv
    _check(
        missing, uv, "MANO UV template",
        "Ship `MANO_UV_right.obj` from the reference's assets/ "
        "(an OBJ with vt/f v/vt lines defining the hand UV atlas).",
    )
    _check(
        missing, getattr(opt, "sem_hand", "assets/semantics_hand.pkl"),
        "hand semantics pickle",
        "Copy `assets/semantics_hand.pkl` from the reference release "
        "(per-vertex semantic part labels; --sem_hand).",
    )

    data_dir = getattr(opt, "data_dir", "")
    _check(
        missing, data_dir, "dataset root (--data_dir)",
        "DexYCB: https://dex-ycb.github.io" if is_ycb
        else "HO3D v3: https://www.tugraz.at/index.php?id=40231",
    )

    obj_root = getattr(opt, "obj_dir", None) or (
        os.path.join(data_dir, "models") if is_ycb else "assets/obj"
    )
    _check(
        missing, obj_root, "object mesh dir",
        "YCB object models dir with <name>/textured_pre.obj per object "
        "(--obj_dir; DexYCB ships it as models/)." if is_ycb
        else "Decimated YCB meshes dir with <name>/<name>.obj per object "
        "(--obj_dir; reference layout assets/obj/).",
    )

    if eval_pairs is not None:
        _check(
            missing, eval_pairs, "evaluation pair list",
            "Pickle of (src, tsf) frame pairs; the reference release ships "
            "assets/eval_pairs_new.pkl (HO3Dv3) / assets/eval_pairs.pkl "
            "(DexYCB).",
        )

    # (--use_vgg without --vgg_weights is warned at the use site,
    # model_api.HOIGModel.__init__ — training still runs)

    if missing:
        raise FileNotFoundError(
            "preflight: %d required asset(s) missing:\n%s"
            % (len(missing), "\n".join(missing))
        )


def _has_mano_pkl(root: str) -> bool:
    for _, _, files in os.walk(root):
        for f in files:
            if f.upper().startswith("MANO_RIGHT") and f.endswith(".pkl"):
                return True
    return False
