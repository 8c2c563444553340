"""patches_per_s (patches/s, higher is better; also read as
``patches_per_s.vit``, a bound of its own): equivalent 224² stride-112
patches of every slide whose map came back, over the seconds from the
first request's submission to the last map's return."""

from port_bench.core.record import patches_per_s


def read(run):
    return patches_per_s(run)
