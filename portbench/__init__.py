"""The benchmark of the PyTorch and CUDA port (``flexynesis_torch``) on one H100."""
