"""Graph convolutions over a fixed gene-interaction graph.

Counterpart of ``flexynesis_tpu/ops/graph_conv.py`` (the reference's flexGCN,
modules.py:153-262, over torch_geometric's GCNConv / SAGEConv / GraphConv /
GATConv). Aggregation is one operator built on the host per conv type:

* ``build_operator`` - the dense (N, N) operator, A[dst, src] = 1:
  GCN D^-1/2 (A + I) D^-1/2, SAGE row-normalised A, GC raw A, GAT the
  adjacency with self-loops (its nonzeros mask the attention);
* ``build_sparse_operator`` - the same operator as a padded, dst-sorted edge
  list ``{src, dst, w}`` (padded edges point at the last node with w = 0),
  the form selected at ``SPARSE_NODE_THRESHOLD`` nodes and above.

A dense aggregation is one product (N, N) @ (N, rows * F); a sparse one
gathers ``x[..., src, :] * w`` and adds the messages into their ``dst`` rows
with ``index_add`` (atomic adds on the card, so the order of a node's sum
varies between runs; the CPU adds in edge order); the sparse GAT is a
per-edge softmax over each dst segment (``scatter_reduce`` amax, then
``index_add`` sums). Both forms give the same function up to rounding.

``DenseGraphConvLayer`` and ``FlexGCN`` carry the Flax module's parameter
names (``lin``, ``lin_root``, ``lin_nbr``, ``att_src``, ``att_dst``, ``bias``;
``conv_<i>``, ``bn_<i>``, ``fc``) and initialisers (Xavier for GCN and GAT,
torch's Linear law for SAGE, GC and ``fc``). Their ``forward_with`` runs on
given parameters, which may carry a leading trial axis K, with node tensors
(B, N, F), (K, B, N, F), or (B, N, F) shared by the K trials. BatchNorm
normalises over batch x nodes, as Flax's ``nn.BatchNorm`` does on a
(B, N, E) input (the rows are reshaped to (B * N, E); ``BatchNorm1d`` on
(B, N, E) would normalise the wrong axis).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .initializers import reset_linear_, torch_linear_uniform_, xavier_uniform_
from .mlp import BN_EPS, BN_MOMENTUM, batch_norm_eval, batch_norm_train, linear, own

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu default
}

Tensors = Dict[str, torch.Tensor]
Operator = Union[torch.Tensor, Tensors]


def build_operator(edge_index: np.ndarray, n_nodes: int, conv_type: str) -> np.ndarray:
    """Dense aggregation operator from a (2, E) COO edge index
    (edge_index[0] = source, edge_index[1] = target: A[t, s] = 1)."""
    A = np.zeros((n_nodes, n_nodes), dtype=np.float32)
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    A[dst, src] = 1.0
    if conv_type == "GCN":
        A = A + np.eye(n_nodes, dtype=np.float32)
        d = A.sum(axis=1)
        dis = 1.0 / np.sqrt(np.where(d > 0, d, 1.0))
        return A * dis[:, None] * dis[None, :]
    if conv_type == "SAGE":
        deg = A.sum(axis=1, keepdims=True)
        return A / np.clip(deg, 1.0, None)
    if conv_type == "GC":
        return A
    if conv_type == "GAT":
        # GATConv's add_self_loops=True: a node's own features join its softmax
        np.fill_diagonal(A, 1.0)
        return A
    raise ValueError(f"Unknown convolution type: {conv_type}")


# the node count from which ``gnn_sparse: "auto"`` takes the edge list (the
# JAX package's threshold, kept so that both packages pick the same form)
SPARSE_NODE_THRESHOLD = 8192


def build_sparse_operator(edge_index: np.ndarray, n_nodes: int, conv_type: str,
                          pad_multiple: int = 512) -> Dict[str, np.ndarray]:
    """The edge-list form of ``build_operator``: ``{"src", "dst": int32 (Ep,),
    "w": float32 (Ep,)}`` sorted by (dst, src), duplicates collapsed as the
    dense ``A[dst, src] = 1`` collapses them, self-loops added for GCN (an
    explicit self-edge doubled, as A + I doubles it) and GAT, zero-padded to
    a multiple of ``pad_multiple``."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    keys = np.unique(dst * n_nodes + src)
    loops = np.arange(n_nodes, dtype=np.int64) * (n_nodes + 1)
    if conv_type == "GCN":
        keys, counts = np.unique(np.concatenate([keys, loops]), return_counts=True)
        dst, src = keys // n_nodes, keys % n_nodes
        deg = np.bincount(dst, weights=counts.astype(np.float64),
                          minlength=n_nodes).astype(np.float32)
        dis = 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))
        w = counts.astype(np.float32) * dis[dst] * dis[src]
    else:
        if conv_type == "GAT":
            keys = np.unique(np.concatenate([keys, loops]))
        dst, src = keys // n_nodes, keys % n_nodes
        deg = np.bincount(dst, minlength=n_nodes).astype(np.float32)
        if conv_type == "SAGE":
            w = 1.0 / np.clip(deg, 1.0, None)[dst]
        elif conv_type in ("GC", "GAT"):
            w = np.ones(len(dst), dtype=np.float32)
        else:
            raise ValueError(f"Unknown convolution type: {conv_type}")
    e = len(dst)
    ep = max(pad_multiple, -(-e // pad_multiple) * pad_multiple)
    out = {
        "src": np.zeros(ep, dtype=np.int32),
        "dst": np.full(ep, n_nodes - 1, dtype=np.int32),
        "w": np.zeros(ep, dtype=np.float32),
    }
    out["src"][:e] = src
    out["dst"][:e] = dst
    out["w"][:e] = w
    return out


def operator_to(op, device) -> Operator:
    """A numpy operator (dense array or edge dict) as tensors on ``device``;
    edge indices as int64 (``scatter_reduce`` takes no other)."""
    if isinstance(op, dict):
        return {"src": torch.as_tensor(np.asarray(op["src"], np.int64), device=device),
                "dst": torch.as_tensor(np.asarray(op["dst"], np.int64), device=device),
                "w": torch.as_tensor(np.asarray(op["w"], np.float32), device=device)}
    return torch.as_tensor(np.asarray(op, np.float32), device=device)


def dense_aggregate(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum('nm,...mf->...nf', A, x)`` as one (N, N) @ (N, rows * F) product."""
    xt = x.movedim(-2, 0)
    y = A @ xt.reshape(xt.shape[0], -1)
    return y.reshape(xt.shape).movedim(0, -2)


def sparse_aggregate(x: torch.Tensor, adj: Tensors) -> torch.Tensor:
    """sum over edges e with dst_e = n of w_e * x[..., src_e, :]."""
    msgs = x.index_select(-2, adj["src"]) * adj["w"].unsqueeze(-1)
    return torch.zeros_like(x).index_add(x.dim() - 2, adj["dst"], msgs)


def aggregate(x: torch.Tensor, adj: Operator) -> torch.Tensor:
    return sparse_aggregate(x, adj) if isinstance(adj, dict) else dense_aggregate(adj, x)


def dense_gat(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
              A: torch.Tensor) -> torch.Tensor:
    """Single-head attention over the masked dense adjacency: scores
    leakyrelu(a_dst_i + a_src_j, 0.2) on A's nonzeros, a softmax per row
    (a row without an edge is all zero) and alpha @ h. The row maximum is a
    constant of the softmax (its gradient cancels), so it is detached."""
    scores = F.leaky_relu(a_dst.unsqueeze(-1) + a_src.unsqueeze(-2), 0.2)
    mask = A > 0
    scores = torch.where(mask, scores, -torch.inf)
    smax = scores.detach().amax(dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    expd = torch.where(mask, torch.exp(scores - smax), 0.0)
    alpha = expd / torch.clamp(expd.sum(dim=-1, keepdim=True), min=1e-9)
    return alpha @ h


def sparse_gat(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
               adj: Tensors) -> torch.Tensor:
    """The edge-list form of ``dense_gat``: a per-edge score and a softmax
    over each dst segment; padded edges (w = 0) are masked out. h (..., N, F),
    a_src and a_dst (..., N)."""
    src, dst, w = adj["src"], adj["dst"], adj["w"]
    n = h.shape[-2]
    scores = F.leaky_relu(a_dst.index_select(-1, dst) + a_src.index_select(-1, src), 0.2)
    valid = w > 0
    neg = torch.finfo(scores.dtype).min  # finite: -inf - -inf would be NaN
    scores = torch.where(valid, scores, neg)
    with torch.no_grad():
        smax = torch.full((*scores.shape[:-1], n), neg, dtype=scores.dtype,
                          device=scores.device)
        smax = smax.scatter_reduce(-1, dst.expand(scores.shape), scores, "amax")
        smax = torch.where(smax > neg / 2, smax, torch.zeros_like(smax))  # no in-edge
    expd = torch.where(valid, torch.exp(scores - smax.index_select(-1, dst)), 0.0)
    denom = torch.zeros_like(a_dst).index_add(a_dst.dim() - 1, dst, expd)
    alpha = expd / torch.clamp(denom.index_select(-1, dst), min=1e-9)
    msgs = h.index_select(-2, src) * alpha.unsqueeze(-1)
    return torch.zeros_like(h).index_add(h.dim() - 2, dst, msgs)


def node_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ops.mlp.linear`` on node tensors (..., B, N, F): the (B, N) rows
    flattened into one axis, so K trials' weights (K, out, in) take a
    (K, B, N, F) input or one (B, N, F) shared by the trials."""
    B, N, f = x.shape[-3:]
    y = linear(x.reshape(*x.shape[:-3], B * N, f), weight, bias)
    return y.reshape(*y.shape[:-2], B, N, y.shape[-1])


class DenseGraphConvLayer(nn.Module):
    """One conv step (dense or sparse operator alike):

    GCN:      X' = (A_op X) W + b            (``lin``)
    SAGE/GC:  X' = X W_root + b + (A_op X) W_nbr   (``lin_root``, ``lin_nbr``)
    GAT:      X' = masked-softmax attention aggregation of X W, + bias
              (``lin``, ``att_src``, ``att_dst``, ``bias``)
    """

    def __init__(self, in_dim: int, out_dim: int, conv_type: str):
        super().__init__()
        self.conv_type = conv_type
        if conv_type == "GCN":
            self.lin = nn.Linear(in_dim, out_dim)
        elif conv_type == "GAT":
            self.lin = nn.Linear(in_dim, out_dim, bias=False)
            self.att_src = nn.Linear(out_dim, 1, bias=False)
            self.att_dst = nn.Linear(out_dim, 1, bias=False)
            self.bias = nn.Parameter(torch.zeros(out_dim))
        elif conv_type in ("SAGE", "GC"):
            self.lin_root = nn.Linear(in_dim, out_dim)
            self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)
        else:
            raise ValueError(f"Unknown convolution type: {conv_type}")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.conv_type == "GCN":
            xavier_uniform_(self.lin.weight, generator)
            self.lin.bias.zero_()
        elif self.conv_type == "GAT":
            for m in (self.lin, self.att_src, self.att_dst):
                xavier_uniform_(m.weight, generator)
            self.bias.zero_()
        else:
            reset_linear_(self.lin_root, generator)
            torch_linear_uniform_(self.lin_nbr.weight, self.lin_nbr.in_features, generator)

    def forward_with(self, params: Tensors, x: torch.Tensor, adj: Operator) -> torch.Tensor:
        """The layer on ``params`` named as its own (optional trial axis)."""
        if self.conv_type == "GCN":
            return node_linear(aggregate(x, adj), params["lin.weight"], params["lin.bias"])
        if self.conv_type == "GAT":
            h = node_linear(x, params["lin.weight"])
            a_src = node_linear(h, params["att_src.weight"])[..., 0]
            a_dst = node_linear(h, params["att_dst.weight"])[..., 0]
            gat = sparse_gat if isinstance(adj, dict) else dense_gat
            bias = params["bias"]
            # a trial axis puts K ahead of (B, N, E): (K, E) -> (K, 1, 1, E)
            if bias.dim() == 2:
                bias = bias[:, None, None, :]
            return gat(h, a_src, a_dst, adj) + bias
        root = node_linear(x, params["lin_root.weight"], params["lin_root.bias"])
        return root + node_linear(aggregate(x, adj), params["lin_nbr.weight"])


class FlexGCN(nn.Module):
    """``num_convs`` conv layers, each followed by BatchNorm over batch x
    nodes, the activation and dropout 0.2; then a ``flatten`` readout (all
    node embeddings, the reference's FC head) or a ``mean`` over nodes; then
    the Linear ``fc`` to ``output_dim``."""

    def __init__(self, n_nodes: int, in_dim: int, node_embedding_dim: int, output_dim: int,
                 num_convs: int = 2, conv_type: str = "GC", activation: str = "relu",
                 dropout_rate: float = 0.2, readout: str = "flatten"):
        super().__init__()
        self.num_convs = int(num_convs)
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.readout = readout
        E = int(node_embedding_dim)
        for i in range(self.num_convs):
            self.add_module(f"conv_{i}", DenseGraphConvLayer(in_dim if i == 0 else E, E,
                                                             conv_type))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(E, eps=BN_EPS, momentum=BN_MOMENTUM))
        self.fc = nn.Linear(E if readout == "mean" else n_nodes * E, output_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_convs):
            getattr(self, f"conv_{i}").reset_parameters(generator)
            getattr(self, f"bn_{i}").reset_parameters()
        reset_linear_(self.fc, generator)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor, adj: Operator,
                     train: bool, drop: Optional[Callable]) -> torch.Tensor:
        """x (..., B, N, n_feats) -> (..., B, output_dim) on given parameters
        and running statistics; in training mode batch statistics (the
        running ones updated in place) and ``drop(h, rate)``."""
        act = ACTIVATIONS[self.activation]
        norm = batch_norm_train if train else batch_norm_eval
        for i in range(self.num_convs):
            h = getattr(self, f"conv_{i}").forward_with(own(params, f"conv_{i}"), x, adj)
            B, N, E = h.shape[-3:]
            rows = norm(h.reshape(*h.shape[:-3], B * N, E),
                        params[f"bn_{i}.weight"], params[f"bn_{i}.bias"],
                        buffers[f"bn_{i}.running_mean"], buffers[f"bn_{i}.running_var"])
            x = act(rows).reshape(h.shape)
            if train:
                x = drop(x, self.dropout_rate)
        if self.readout == "mean":
            x = x.mean(dim=-2)
        else:
            x = x.reshape(*x.shape[:-2], -1)
        return linear(x, params["fc.weight"], params["fc.bias"])
