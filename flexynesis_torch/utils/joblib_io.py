"""joblib's file format for the preprocessing artifact, with ``pickle`` and numpy.

The JAX package (and the reference) write ``<prefix>.artifacts.joblib`` with
``joblib.dump``: a pickle (protocol 4) of the artifact dict, whose scalers and
label encoders are fitted sklearn objects. joblib keeps every numpy array out
of the pickle: it pickles a ``joblib.numpy_pickle.NumpyArrayWrapper``
(subclass, shape, order, dtype, allow_mmap, numpy_array_alignment_bytes) in
the array's place, ends the pickle frame, and writes the array right after
it: one byte giving the padding's length, that many ``0xff`` bytes so the
data starts at a multiple of 16 bytes into the file, then the raw bytes in the
wrapper's order. An array of Python objects follows as a pickle of its own
(protocol 5) instead. On load, joblib hooks the BUILD opcode to swap each
wrapper for the array it reads from the file. ``Reader`` does the same on the
pure-Python unpickler: the C unpickler can hook no opcode, and it buffers its
reads.

``load`` resolves an allow-list of globals only (``ALLOWED``): sklearn's
StandardScaler, OrdinalEncoder and LabelEncoder become ``Pickled`` stand-ins
that keep the dict their ``__setstate__`` gets; joblib's wrapper becomes the
array it stands for; numpy's reconstructors and scalar types, named under
numpy 2's ``numpy._core`` or numpy 1's ``numpy.core``, map to this numpy's.
Any other global raises ``pickle.UnpicklingError`` naming it, before it can be
called (``joblib.load`` runs any pickle). Compressed joblib files are refused.

``dump`` writes the stream ``joblib.dump`` writes for the same objects, with
the stand-ins in place of the sklearn objects: ``Writer`` names sklearn's and
joblib's classes itself, since the pickler's own ``save_global`` imports a
class's module to check it. Which repeated objects the stream refers back to
follows object identity, as in joblib.
"""

from __future__ import annotations

import copyreg
import pickle

import numpy as np

PROTOCOL = 4  # pickle.DEFAULT_PROTOCOL of Python 3.8-3.13, which joblib.dump uses
INLINE_PROTOCOL = 5  # joblib's protocol for an array of Python objects
ALIGNMENT = 16  # joblib's NUMPY_ARRAY_ALIGNMENT_BYTES (since joblib 1.2)


class Pickled:
    """A stand-in for an allow-listed class: ``state`` is the dict its
    ``__setstate__`` gets (``vars()`` of the object, and for an sklearn
    estimator its ``_sklearn_version``)."""

    module = ""

    def __new__(cls, *args):
        self = object.__new__(cls)
        self.state = {}
        return self

    def __init__(self, state=None):
        self.state = dict(state or {})

    def __setstate__(self, state):
        if not isinstance(state, dict):
            raise pickle.UnpicklingError(
                f"{self.module}.{type(self).__name__}: state is a {type(state).__name__}, "
                "not a dict")
        self.state = state

    def __reduce_ex__(self, protocol):
        return copyreg.__newobj__, (type(self),), self.state


class StandardScaler(Pickled):
    module = "sklearn.preprocessing._data"


class OrdinalEncoder(Pickled):
    module = "sklearn.preprocessing._encoders"


class LabelEncoder(Pickled):
    module = "sklearn.preprocessing._label"


class NumpyArrayWrapper(Pickled):
    """joblib's placeholder of an array; ``Reader`` replaces it by the array
    whose bytes follow it in the file."""

    module = "joblib.numpy_pickle"

    @classmethod
    def of(cls, array: np.ndarray, alignment):
        """The wrapper ``joblib.dump`` pickles for ``array``; with
        ``alignment`` None, the layout of joblib 1.1 and older."""
        order = "F" if array.flags.f_contiguous and not array.flags.c_contiguous else "C"
        state = {"subclass": np.ndarray, "shape": array.shape, "order": order,
                 "dtype": array.dtype, "allow_mmap": not array.dtype.hasobject}
        if alignment is not None:
            state["numpy_array_alignment_bytes"] = alignment
        return cls(state)

    def read(self, fh) -> np.ndarray:
        s = self.state
        if s.get("subclass", np.ndarray) is not np.ndarray:
            raise pickle.UnpicklingError(f"array subclass {s['subclass']!r} is not allowed")
        dtype, shape, order = s["dtype"], tuple(s["shape"]), s.get("order", "C")
        if dtype.hasobject:
            array = Reader(fh).load()
            if not isinstance(array, np.ndarray):
                raise pickle.UnpicklingError("an object array's pickle holds no array")
            return array
        if s.get("numpy_array_alignment_bytes") is not None:
            pad = fh.read(1)
            if len(pad) != 1 or len(fh.read(pad[0])) != pad[0]:
                raise pickle.UnpicklingError("file ends inside an array's padding")
        count = int(np.prod(shape, dtype=np.int64))
        buf = bytearray(count * dtype.itemsize)
        if fh.readinto(buf) != len(buf):
            raise pickle.UnpicklingError("file ends inside an array's data")
        array = np.frombuffer(buf, dtype=dtype, count=count)
        array = array.reshape(shape[::-1]).T if order == "F" else array.reshape(shape)
        if not array.dtype.isnative:
            array = array.astype(array.dtype.newbyteorder("="))
        return array

    def write(self, pickler: "Writer", array: np.ndarray) -> None:
        """The array's bytes as ``NumpyArrayWrapper.write_array`` writes them."""
        fh = pickler.fh
        if array.dtype.hasobject:
            type(pickler)(fh, INLINE_PROTOCOL, arrays_out_of_band=False).dump(array)
            return
        alignment = self.state.get("numpy_array_alignment_bytes")
        if alignment is not None:
            pad = alignment - (fh.tell() + 1) % alignment
            fh.write(bytes([pad]) + b"\xff" * pad)
        fh.write(array.tobytes(self.state["order"]))


def _numpy_globals() -> dict:
    try:
        from numpy._core import multiarray, numeric
    except ImportError:  # numpy 1
        from numpy.core import multiarray, numeric
    local = {("multiarray", "_reconstruct"): multiarray._reconstruct,
             ("multiarray", "scalar"): multiarray.scalar,
             ("numeric", "_frombuffer"): numeric._frombuffer}
    out = {(f"{package}.{module}", name): obj
           for package in ("numpy._core", "numpy.core")
           for (module, name), obj in local.items()}
    out[("numpy", "ndarray")] = np.ndarray
    out[("numpy", "dtype")] = np.dtype
    scalar_types = set(np.sctypeDict.values())
    for name in {t.__name__ for t in scalar_types} | {"bool_", "bool"}:
        t = getattr(np, name, None)
        if t in scalar_types:
            out[("numpy", name)] = t
    return out


STAND_INS = (StandardScaler, OrdinalEncoder, LabelEncoder, NumpyArrayWrapper)
ALLOWED = {**{(c.module, c.__name__): c for c in STAND_INS}, **_numpy_globals()}


class Reader(pickle._Unpickler):
    """joblib's ``NumpyUnpickler`` over the allow-list."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, fh):
        super().__init__(fh)
        self.fh = fh

    def find_class(self, module, name):
        obj = ALLOWED.get((module, name))
        if obj is None:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not on the joblib artifact allow-list")
        return obj

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], NumpyArrayWrapper):
            frame = self._unframer.current_frame
            if frame is not None and frame.tell() != len(frame.getbuffer()):
                raise pickle.UnpicklingError("array data inside a pickle frame")
            self.stack[-1] = self.stack[-1].read(self.fh)

    dispatch[pickle.BUILD[0]] = load_build


class Writer(pickle._Pickler):
    """joblib's ``NumpyPickler``, naming the stand-ins' classes itself."""

    alignment = ALIGNMENT

    def __init__(self, fh, protocol: int = PROTOCOL, arrays_out_of_band: bool = True):
        super().__init__(fh, protocol=protocol)
        self.fh = fh
        self.arrays_out_of_band = arrays_out_of_band

    def save(self, obj, save_persistent_id=True):
        if not (self.arrays_out_of_band and type(obj) is np.ndarray):
            return super().save(obj, save_persistent_id)
        wrapper = NumpyArrayWrapper.of(obj, self.alignment)
        super().save(wrapper)
        self.framer.commit_frame(force=True)  # the array's bytes follow the wrapper's frame
        wrapper.write(self, obj)

    def save_global(self, obj, name=None):
        if not (isinstance(obj, type) and issubclass(obj, Pickled)):
            return super().save_global(obj, name)
        self.save(obj.module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def load(path: str):
    """The object ``joblib.load(path)`` gives, the sklearn objects as
    ``Pickled`` stand-ins; raises on a global off the allow-list."""
    with open(path, "rb") as fh:
        if fh.read(1) != pickle.PROTO:
            raise ValueError(f"{path} is not an uncompressed joblib pickle")
        fh.seek(0)
        return Reader(fh).load()


def dump(obj, path: str) -> str:
    """Write ``obj`` as ``joblib.dump(obj, path)`` does."""
    with open(path, "wb") as fh:
        Writer(fh).dump(obj)
    return path
