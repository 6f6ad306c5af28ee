"""Model registry: the ``--model_class`` names the port trains and rebuilds
(flexynesis_tpu/models/__init__.py:11-17)."""

from .crossmodal_pred import CrossModalPred
from .direct_pred import DirectPred
from .gnn import GNN
from .supervised_vae import SupervisedVAE
from .triplet_encoder import MultiTripletNetwork

MODEL_REGISTRY = {
    "DirectPred": DirectPred,
    "supervised_vae": SupervisedVAE,
    "MultiTripletNetwork": MultiTripletNetwork,
    "CrossModalPred": CrossModalPred,
    "GNN": GNN,
}
