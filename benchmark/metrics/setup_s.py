"""Set-up seconds: from process start to the first timed step or call
(imports, kernel cache, tables, weights and inputs on the device, the
checked first steps or the warm-up calls)."""


def read(run):
    return run.setup_s
