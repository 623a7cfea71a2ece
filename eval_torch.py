"""Evaluation driver of the PyTorch/CUDA port (the counterpart of eval.py).

    python eval_torch.py --dataset_mode synthetic --load_epoch 1 --output_dir out ...
    python eval_torch.py --device cpu ...   # the plain PyTorch path, no card

Pair-driven generation on one card (CUDA unless --device cpu; without a
card it raises). Writes the `source/`, `imitators/` (fakes) and `gt/` PNG
trees that the FID / LPIPS / SSIM scripts read, each batch grid untiled
into image_size crops as the reference does (eval.py:70-79). The PNGs are
8-bit RGB from a stdlib encoder (hoig_torch.utils.util.save_image): no PIL
or cv2. `pairs_dir` is fixed as in the reference (eval.py:32) unless the
dataset is synthetic.
"""

from __future__ import annotations

import os

from hoig_torch.utils.util import save_image


def main(argv=None, env=None):
    """Run the evaluation; returns the model (its weights and last batch).
    A caller-built `env` (see build_environment) skips the asset preflight."""
    from hoig_torch.data.loader import CustomDatasetDataLoader
    from hoig_torch.options.test_options import TestOptions
    from hoig_torch.train.model_api import ModelsFactory

    opt = TestOptions().parse(argv)
    if opt.dataset_mode != "synthetic":
        opt.pairs_dir = ("assets/eval_pairs_new.pkl" if opt.dataset_mode == "hov3"
                         else "assets/eval_pairs.pkl")
        if env is None:
            from hoig_torch.utils.preflight import preflight_assets

            preflight_assets(opt, eval_pairs=opt.pairs_dir)
    opt.serial_batches = True
    opt.is_train = False
    opt.bg_both = False

    data_loader = CustomDatasetDataLoader(opt, is_for_train=False)
    dataset = data_loader.load_data()
    if env is None and opt.dataset_mode == "synthetic":
        from hoig_torch.geometry.conditioning import ConditioningConfig

        env = dict(data_loader.dataset.environment(opt.device),
                   ccfg=ConditioningConfig(image_size=opt.image_size), is_ycb=False)
    model = ModelsFactory.get_by_name(opt.model, opt, env=env)

    sav_dir = opt.output_dir
    for sub in ("source", "imitators", "gt"):
        os.makedirs(os.path.join(sav_dir, sub), exist_ok=True)

    model.set_eval()
    s = opt.image_size
    for i_val_batch, val_batch in enumerate(dataset):
        model.set_input(val_batch)
        # generation only: no eval losses (D and VGG passes), nothing reads them
        model.forward(keep_data_for_visuals=True, compute_losses=False)
        visuals = model.get_current_visuals()
        cols = visuals["14_batch_real_img"].shape[1] // s
        for i in range(len(val_batch["nameA"])):
            r, c = i // cols, i % cols
            # names are "<vid>/<frame>", where vid may be nested (DexYCB:
            # "subject/seq/cam"): flattened with '_' as the reference does
            # (HOIG_DexYCB/eval.py:72-74 joins parts[:-1])
            src_parts = val_batch["nameA"][i].split("/")
            tsf_frame = val_batch["nameB"][i].split("/")[-1]
            src_vid, src_frame = "_".join(src_parts[:-1]), src_parts[-1]
            stem = (f"{src_vid}_{os.path.splitext(src_frame)[0]}_"
                    f"{os.path.splitext(tsf_frame)[0]}.png")
            crop = lambda key: visuals[key][r * s: r * s + s, c * s: c * s + s]
            save_image(crop("16_batch_src_img"), os.path.join(sav_dir, "source", stem))
            save_image(crop("15_batch_fake_img"), os.path.join(sav_dir, "imitators", stem))
            save_image(crop("14_batch_real_img"), os.path.join(sav_dir, "gt", stem))
        print(f"batch {i_val_batch + 1} done")
    return model


if __name__ == "__main__":
    main()
