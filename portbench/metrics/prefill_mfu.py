"""The prefill's share of the card's peak: the forward FLOPs of the tokens
prefilled in the window (the layers' matmuls, σ attention against each
token's cached prefix, the VQ scores and the output head,
``work.forward_flops``) over the window, less the seconds spent reading
the trace in it, times the peak, in %."""
from portbench import bench, work


def read(obs: dict):
    if not obs.get("window_s") or "prefill_flops" not in obs:
        return None
    return 100.0 * obs["prefill_flops"] / (bench.working_seconds(obs) * work.PEAK_FLOPS)
