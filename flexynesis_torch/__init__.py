"""flexynesis_torch: the PyTorch/CUDA port of flexynesis_tpu for NVIDIA Hopper.

The package serves DirectPred models saved in flexynesis_tpu's format
(``python -m flexynesis_torch --pretrained_model ...``). Its eval-mode fused
Linear->BatchNorm->ReLU runs as a hand-written CUDA kernel
(``kernels/fused_linear.py``). Entry points run on the CUDA card unless the
caller asks for the CPU (``utils/device.py``).
"""

__version__ = "0.1.0"
