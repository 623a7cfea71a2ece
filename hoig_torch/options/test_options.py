"""Eval flags (port of hoig_tpu/options/test_options.py; reference
options/test_options.py:7-24)."""

from __future__ import annotations

from hoig_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self._parser
        p.add_argument("--output_dir", type=str, default="./outputs/results/")
        p.add_argument("--bg_model", type=str, default="ORIGINAL")
        p.add_argument("--ip", type=str, default="http://localhost")
        p.add_argument("--port", type=int, default=8097)
        p.add_argument("--save_res", action="store_true", default=False)
        self.is_train = False
