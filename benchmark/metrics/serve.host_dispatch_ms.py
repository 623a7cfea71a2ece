"""Host ms per traced call inside the conditioning and the generator
(spans `conditioning` and `generator`)."""

from benchmark.lib import spans


def read(run):
    return spans.host_ms(run, "conditioning", "generator")
