"""``vq_assign``'s share of its roofline in the traced span: the sum of
each call's bound (``work.vq_assign_work`` from its rows and codebook)
over the kernel's device seconds, in %. A call is one launch; a launch
the harness did not record fails the run (``bench.roofline_share``)."""
from portbench import bench


def read(obs: dict):
    return bench.roofline_share(obs.get("vq_assign"), per_call=1)
