from repro_torch.data.synthetic import SyntheticCorpus, lm_batches  # noqa: F401
from repro_torch.data.edit_stream import (  # noqa: F401
    EditStream, TrafficGenerator, revision_pairs,
)
