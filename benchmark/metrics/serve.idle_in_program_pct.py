"""Share of the traced calls' device idle time whose gaps opened while the
host was inside the program's spans; the rest opened in the caller's loop."""

from benchmark.lib import spans


def read(run):
    return spans.idle_in_program_pct(run)
