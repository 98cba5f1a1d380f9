"""``fused_step``'s share of its roofline in the traced span: the sum of
each launch's bound (``work.fused_step_work`` from its shapes and live
mask entries) over the kernel's device seconds, in %. A call is one
launch; a launch the harness did not record fails the run
(``bench.roofline_share``)."""
from portbench import bench


def read(obs: dict):
    return bench.roofline_share(obs.get("fused_step"), per_call=1)
