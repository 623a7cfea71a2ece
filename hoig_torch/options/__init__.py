from hoig_torch.options.base_options import BaseOptions
from hoig_torch.options.test_options import TestOptions
from hoig_torch.options.train_options import TrainOptions
