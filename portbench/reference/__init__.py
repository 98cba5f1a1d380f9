"""The plain PyTorch reference of the benchmark (``vqt``) and the documents'
tokens and position ids worked out from the edit stream (``docs``). Nothing
here imports the program under test."""
