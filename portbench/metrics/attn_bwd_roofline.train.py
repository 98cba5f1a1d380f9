"""The σ attention backward kernels' (dK/dV and dQ) share of their
roofline in the traced span: the sum of each call's bound
(``work.attention_bwd_work`` from (BH, n, dh)) over the kernels' device
seconds, in %. A call is two launches, dK/dV then dQ; a launch the
harness did not record fails the run (``bench.roofline_share``)."""
from portbench import bench


def read(obs: dict):
    return bench.roofline_share(obs.get("attn_bwd"), per_call=2)
