"""The whole edit step's share of the card's peak: for each edit served in
the window, the useful FLOPs of a one-edit step (C = 1, R = 1: the edited
row, which every layer recomputes) over the document's length at that
edit (``work.edit_step_flops``), summed, over the window, less the seconds spent reading
the trace in it, times the peak,
in %. A floor on the work that no grouping or padding changes."""
from portbench import bench, work


def read(obs: dict):
    if not obs.get("window_s") or "edit_flops" not in obs:
        return None
    return 100.0 * obs["edit_flops"] / (bench.working_seconds(obs) * work.PEAK_FLOPS)
