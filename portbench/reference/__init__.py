"""The plain reference: plain PyTorch in float32, importing nothing of the
program (``flexynesis_torch``), its kernels' plain versions or its tests."""
