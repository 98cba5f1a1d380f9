from repro_torch.checkpoint.store import (  # noqa: F401
    atomic_savez, restore_document_state, restore_serving_document,
    save_document_state, save_serving_document,
)
