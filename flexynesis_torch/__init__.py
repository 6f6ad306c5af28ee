"""flexynesis_torch: the PyTorch/CUDA port of flexynesis_tpu for NVIDIA Hopper.

``python -m flexynesis_torch`` trains, tunes (GP search over stacked trials,
with CV, fine-tuning and a resumable search), evaluates and serves all five
deep model classes (DirectPred, supervised_vae, MultiTripletNetwork,
CrossModalPred, GNN) on CSV or HDF5 folders, with marker finding, the
classical baselines and ``--profile``; ``python -m
flexynesis_torch.csv_to_h5`` converts CSV matrices to HDF5. Models load and
save in flexynesis_tpu's format. The Pallas kernels of the JAX package are
hand-written CUDA kernels here (``kernels/``, ``csrc/``). Entry points run
on the CUDA card unless the caller asks for the CPU (``utils/device.py``).
"""

__version__ = "0.1.0"
