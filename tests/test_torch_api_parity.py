"""The port does all that the JAX package does: every public function and
class defined in a module of ``flexynesis_tpu`` (but ``ops/pallas/``, whose
kernels are ``kernels/`` and ``csrc/``), every public method and property of
those classes (inherited ones too, where a class of ``flexynesis_tpu``
defines them) and every public module-level name (and every name of its
``__all__``: the facades' re-exports) has its counterpart in the same module
of ``flexynesis_torch``, and that counterpart takes every parameter the JAX
signature names (inherited methods count on the port's side, and a
constructor that passes ``*args, **kwargs`` on is read through to the one it
calls).

The only misses allowed are the recorded departures below, each with its
reason. A departure is keyed by the JAX name (``module:Class.method``); a
method inherited from a JAX base class is covered by the base's entry. A
departure that is no longer a miss, or that names nothing the check visits,
fails, so the table cannot go stale."""

import __future__
import ast
import importlib
import inspect
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "flexynesis_tpu"


def _module_names():
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        if rel.parts[:3] == ("flexynesis_tpu", "ops", "pallas"):
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


MODULES = _module_names()

# reasons, each shared by several departures
FLAX_MODULE = ("Flax module plumbing: every flax.linen.Module takes the fields `parent` and "
               "`name` and builds its submodules in `setup`; a torch.nn.Module builds them in "
               "__init__ and is named by its parent's attribute (convert.py maps the names)")
FLAX_TRAIN = ("Flax takes the mode as `train=`; a torch.nn.Module reads `self.training` "
              "(module.train() / eval()) and takes the dropout generator")
FUNCTIONAL = ("Flax's functional state: JAX threads `params`, `batch_stats` and a PRNG key "
              "through each call; the port's modules own their parameters and buffers, and "
              "noise comes from torch.Generator")
PANDAS = ("pandas frames: the port does not use pandas and takes arrays with their row and "
          "column names (`Layer`, `Clinical`, `utils.csvio.Table`) in their place")
PRNG_KEY = ("a JAX PRNG key: the port takes the prior draws or a torch.Generator "
            "(`prior=`, `generator=`)")
MATMUL_PRECISION = ("the TPU's bfloat16 matmul passes: the port's trial engine runs its "
                    "products in float32 (ROADMAP, Recorded choices)")
ORBAX = ("orbax's pytree template and state arguments: the port's checkpointer saves a "
         "dict of named tensors and a JSON meta (train/checkpoint.py)")
FLAX_INIT = ("a Flax initializer factory (`init(key, shape, dtype)`): the port initialises "
             "its modules in place to the same distributions (ops/initializers.py "
             "`torch_linear_uniform_`, `reset_linear_`, `xavier_uniform_`)")
INIT_PARAMS = ("a Flax module is initialised from an example batch; the port's module is built "
               "with its shapes in the constructor, so `init_params` takes only the seed")

# "module:qualname" -> (the parameters the port does not take, or None where
# the port has no such name; the reason)
DEPARTURES = {
    "flexynesis_tpu.coexpression:build_network": (("expr",), PANDAS),
    "flexynesis_tpu.data.covariates:get_variable_types": (("df",), PANDAS),
    "flexynesis_tpu.data.covariates:create_covariate_matrix": (("ann",), PANDAS),
    "flexynesis_tpu.data.dataset:MultiOmicDataset.get_feature_subset": (("feature_df",), PANDAS),
    "flexynesis_tpu.data.feature_selection:remove_redundant_features":
        (("laplacian_scores",), PANDAS + "; the scores are `scores`"),
    "flexynesis_tpu.data.importer:DataImporter.cleanup_data": (("df_dict",), PANDAS),
    "flexynesis_tpu.data.importer:DataImporter.get_labels": (("dat", "ann"), PANDAS),
    "flexynesis_tpu.data.importer:DataImporter.select_features": (("dat",), PANDAS),
    "flexynesis_tpu.data.importer:DataImporter.transform_data": (("data",), PANDAS),
    "flexynesis_tpu.data.importer:DataImporter.normalize_data": (
        ("data", "scaler_type"),
        PANDAS + "; `scaler_type='min_max'` (sklearn's MinMaxScaler) has no caller in the JAX "
        "package and neither package's JSON artifacts can store that scaler: the port fits "
        "the StandardScaler every caller uses"),
    "flexynesis_tpu.data.importer:DataImporter.encode_labels": (("df",), PANDAS),
    "flexynesis_tpu.data.importer:DataImporter.get_dataset": (("dat", "ann"), PANDAS),
    "flexynesis_tpu.interpret.attribution:integrated_gradients": (
        ("target_class",),
        "the port attributes a list of classes in one pass (`classes`) where JAX takes one"),
    "flexynesis_tpu.interpret.attribution:gradient_shap": (
        ("target_class",),
        "the port attributes a list of classes in one pass (`classes`) where JAX takes one"),
    "flexynesis_tpu.models.base:BaseModel.init_params": (("dataset",), INIT_PARAMS),
    "flexynesis_tpu.models.gnn:GNN.init_params": (("dataset",), INIT_PARAMS),
    "flexynesis_tpu.models.base:BaseModel.loss_fn": (("params", "batch_stats", "rng"),
                                                     FUNCTIONAL),
    "flexynesis_tpu.models.crossmodal_pred:CrossModalPredNet.__init__": (("parent", "name"),
                                                                       FLAX_MODULE),
    "flexynesis_tpu.models.crossmodal_pred:CrossModalPredNet.setup": (None, FLAX_MODULE),
    "flexynesis_tpu.models.direct_pred:DirectPredNet.__init__": (("parent", "name"),
                                                               FLAX_MODULE),
    "flexynesis_tpu.models.direct_pred:DirectPredNet.setup": (None, FLAX_MODULE),
    "flexynesis_tpu.models.direct_pred:DirectPredNet.encode": (("train",), FLAX_TRAIN),
    "flexynesis_tpu.models.gnn:GNNNet.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.models.gnn:GNNNet.setup": (None, FLAX_MODULE),
    "flexynesis_tpu.models.supervised_vae:SupervisedVAENet.__init__": (("parent", "name"),
                                                                     FLAX_MODULE),
    "flexynesis_tpu.models.supervised_vae:SupervisedVAENet.setup": (None, FLAX_MODULE),
    "flexynesis_tpu.models.triplet_encoder:TripletNet.__init__": (("parent", "name"),
                                                                FLAX_MODULE),
    "flexynesis_tpu.models.triplet_encoder:TripletNet.setup": (None, FLAX_MODULE),
    "flexynesis_tpu.models.triplet_encoder:MultiTripletNetwork.loss_fn": (
        ("params", "batch_stats", "rng"), FUNCTIONAL),
    "flexynesis_tpu.ops.fused_mlp:FusedMLP.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.ops.graph_conv:DenseGraphConvLayer.__init__": (("parent", "name"),
                                                                  FLAX_MODULE),
    "flexynesis_tpu.ops.graph_conv:FlexGCN.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.ops.mlp:MLP.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.ops.mlp:Encoder.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.ops.mlp:Decoder.__init__": (("parent", "name"), FLAX_MODULE),
    "flexynesis_tpu.ops.initializers:torch_linear_kernel_init": (None, FLAX_INIT),
    "flexynesis_tpu.ops.initializers:make_torch_bias_init": (None, FLAX_INIT),
    "flexynesis_tpu.ops.initializers:xavier_uniform": (None, FLAX_INIT),
    "flexynesis_tpu.ops.losses:mmd_loss": (("key",), PRNG_KEY),
    "flexynesis_tpu.ops.losses:masked_mmd_loss": (("key",), PRNG_KEY),
    "flexynesis_tpu.ops.sr_adam:trial_update_step": (
        ("rng", "mask"),
        "JAX splits the trial's PRNG key (`rng`) for the rounding bits; the port takes the "
        "step's SR seeds (`seed`) and one mask per parameter (`masks`)"),
    "flexynesis_tpu.parallel.trials:vmapped_grid_fit": (("matmul_precision",),
                                                        MATMUL_PRECISION),
    "flexynesis_tpu.parallel.trials:ParallelTrials.__init__": (("matmul_precision",),
                                                             MATMUL_PRECISION),
    "flexynesis_tpu.train.checkpoint:TrainCheckpointer.maybe_save": (
        ("params", "opt_state", "batch_stats", "rng", "best_val"), ORBAX),
    "flexynesis_tpu.train.checkpoint:TrainCheckpointer.save": (
        ("params", "opt_state", "batch_stats", "rng", "best_val"), ORBAX),
    "flexynesis_tpu.train.checkpoint:TrainCheckpointer.restore": (("template",), ORBAX),
    "flexynesis_tpu.train.hpo:HyperparameterTuning.__init__": (
        ("num_workers",),
        "the reference's DataLoader worker count: the JAX tuner takes it and never reads "
        "it; the port's data lives on the device and it has no loader workers"),
    "flexynesis_tpu.train.trainer:TrainResult.__init__": (
        ("params", "batch_stats"), FUNCTIONAL + "; the best state is one state_dict, `state`"),
    "flexynesis_tpu.train.trainer:make_optimizer": (
        None, "optax's chain(clip_by_global_norm, adam): the port's `ClippedAdam` class "
        "writes the same formulas (train/trainer.py)"),
    "flexynesis_tpu.train.trainer:Trainer.fit": (("params", "batch_stats", "rng"),
                                                 FUNCTIONAL),
    "flexynesis_tpu.train.trainer:Trainer.validate": (("params", "batch_stats"), FUNCTIONAL),
    "flexynesis_tpu.utils.cbioportal:CBioPortalData.process_data": (("df",), PANDAS),
    "flexynesis_tpu.utils.cbioportal:CBioPortalData.binarize_mutations": (("df",), PANDAS),
    "flexynesis_tpu.utils.survival:CoxPH.fit": (("df",), PANDAS),
    "flexynesis_tpu.utils.survival:CoxPH.predict_partial_hazard": (("df",), PANDAS),
    "flexynesis_tpu.utils.survival:CoxPH.predict_survival_function": (("df",), PANDAS),
    "flexynesis_tpu.utils.survival:recursive_binary_split_minN": (("df",), PANDAS),
    "flexynesis_tpu.utils.survival:build_cox_model": (("df",), PANDAS),
    "flexynesis_tpu.utils.synthetic:make_synthetic_frames": (
        None, PANDAS + "; `make_synthetic_arrays` and `write_synthetic_folder` make the same "
        "data"),
}

_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _params(fn):
    """(named parameters but self/cls, whether it also takes *args/**kwargs),
    or None where inspect cannot read a signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    named = [p.name for p in sig.parameters.values()
             if p.kind not in _VARIADIC and p.name not in ("self", "cls")]
    return named, any(p.kind in _VARIADIC for p in sig.parameters.values())


def _init_params(cls):
    """The constructor's named parameters, read through each __init__ that
    passes ``*args``/``**kwargs`` on to the next one in the MRO."""
    names = []
    for klass in cls.__mro__:
        init = vars(klass).get("__init__")
        if init is None:
            continue
        read = _params(init)
        if read is None:
            break
        names += [n for n in read[0] if n not in names]
        if not read[1]:
            break
    return names


def _public_defs(module_name):
    """(name, kind) of the public functions, classes and assigned names at the
    top level of the module's source (inside top-level if/try too), and the
    names of its ``__all__`` (a facade's re-exports)."""
    path = REPO / (module_name.replace(".", "/") + ".py")
    if not path.exists():
        path = REPO / module_name.replace(".", "/") / "__init__.py"
    out = []

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((node.name, "function"))
            elif isinstance(node, ast.ClassDef):
                out.append((node.name, "class"))
            elif isinstance(node, ast.Assign):
                out.extend((t.id, "name") for t in node.targets if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                out.append((node.target.id, "name"))
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
    visit(ast.parse(path.read_text()).body)
    module = importlib.import_module(module_name)
    out.extend((n, "name") for n in getattr(module, "__all__", ())
               if not isinstance(getattr(module, n), (types.ModuleType, __future__._Feature)))
    seen = set()
    return [(n, k) for n, k in out
            if not n.startswith("_") and not (n in seen or seen.add(n))]


def _jax_members(cls):
    """{name: (defining class, attribute)} of the public methods and
    properties ``cls`` defines or inherits from classes of flexynesis_tpu."""
    out = {}
    for klass in cls.__mro__:
        if not klass.__module__.startswith("flexynesis_tpu"):
            continue
        for name, attr in vars(klass).items():
            if name.startswith("_") or name in out:
                continue
            if isinstance(attr, (staticmethod, classmethod)):
                attr = attr.__func__
            if inspect.isfunction(attr) or isinstance(attr, property):
                out[name] = (klass, attr)
    return out


def _lacking(jax_fn, port_fn):
    a, b = _params(jax_fn), _params(port_fn)
    if a is None or b is None:
        return ()
    return tuple(p for p in a[0] if p not in b[0])


def check_module(module_name):
    """({key: (visited key, miss)} for every miss, {keys visited}): a miss is
    None where the port lacks the name, else the parameters it lacks; the
    key is the JAX name, or the base class's for an inherited method."""
    jm = importlib.import_module(module_name)
    pm = importlib.import_module(module_name.replace("flexynesis_tpu", "flexynesis_torch", 1))
    misses, visited = {}, set()

    def record(key, miss, base_key=None):
        visited.add(key)
        if base_key is not None:
            visited.add(base_key)
        if miss is not None and miss == ():
            return
        entry = key if key in DEPARTURES or base_key is None else base_key
        misses[key] = (entry, miss)

    for name, kind in _public_defs(module_name):
        key = f"{module_name}:{name}"
        if not hasattr(pm, name):
            record(key, None)
            continue
        jobj, pobj = getattr(jm, name), getattr(pm, name)
        if kind == "function":
            record(key, _lacking(jobj, pobj))
        elif kind == "class":
            lack = tuple(p for p in _init_params(jobj) if p not in _init_params(pobj))
            record(f"{key}.__init__", lack)
            for mname, (owner, attr) in _jax_members(jobj).items():
                mkey = f"{key}.{mname}"
                base_key = (None if owner is jobj
                            else f"{owner.__module__}:{owner.__qualname__}.{mname}")
                if not hasattr(pobj, mname):
                    record(mkey, None, base_key)
                elif inspect.isfunction(attr):
                    pattr = inspect.getattr_static(pobj, mname)
                    if isinstance(pattr, (staticmethod, classmethod)):
                        pattr = pattr.__func__
                    record(mkey, _lacking(attr, pattr) if callable(pattr) else (), base_key)
                else:
                    record(mkey, (), base_key)
    return misses, visited


@pytest.mark.parametrize("module_name", MODULES)
def test_port_has_every_public_name_and_parameter(module_name):
    misses, visited = check_module(module_name)
    unexplained = {key: miss for key, (entry, miss) in misses.items()
                   if entry not in DEPARTURES or DEPARTURES[entry][0] != miss}
    assert not unexplained, f"the port lacks (None: the name itself): {unexplained}"
    stale = sorted(k for k in DEPARTURES if k.startswith(module_name + ":")
                   and k in visited and k not in {e for e, _ in misses.values()})
    assert not stale, f"recorded departures the port no longer has: {stale}"


def test_every_departure_names_a_jax_name_and_gives_a_reason():
    used = set()
    for module_name in MODULES:
        misses, _ = check_module(module_name)
        used |= {entry for entry, _ in misses.values()}
    assert set(DEPARTURES) == used, sorted(set(DEPARTURES) ^ used)
    for key, (_, reason) in DEPARTURES.items():
        assert isinstance(reason, str) and len(reason) > 20, key
