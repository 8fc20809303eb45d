"""``coalition_images_per_s`` on the four-card mesh, under a name of its own
so that its wider spread gets a bound of its own."""

from bench_port.lib import readers


def read(rec):
    return readers.fact(rec, "images_per_s")
