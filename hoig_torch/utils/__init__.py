from hoig_torch.utils.util import (
    Colorize,
    labelcolormap,
    mkdirs,
    read_json,
    read_pickle,
    save_image,
    tensor2im,
    tensor2maskim,
    write_json,
    write_pickle,
)
