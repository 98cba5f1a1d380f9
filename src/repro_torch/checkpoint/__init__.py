from repro_torch.checkpoint.store import (  # noqa: F401
    atomic_savez, restore_document_state, restore_pytree, restore_serving_document,
    restore_train_state, save_document_state, save_pytree, save_serving_document,
    save_train_state,
)
