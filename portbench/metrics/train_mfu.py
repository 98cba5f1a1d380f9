"""The train step's share of the card's peak: three times the forward
FLOPs of each step's tokens (the layers' matmuls, causal σ attention, the
VQ scores and the tied output head: forward and backward; the layers'
recomputation not counted), over the window, less the seconds spent reading
the trace in it, times the peak, in %."""
from portbench import bench, work


def read(obs: dict):
    if not obs.get("window_s") or "train_flops" not in obs:
        return None
    return 100.0 * obs["train_flops"] / (bench.working_seconds(obs) * work.PEAK_FLOPS)
