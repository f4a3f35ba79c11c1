"""HDF5 files through an h5py-shaped interface, on the port's own format codec
(``utils/hdf5_fmt.py``): no libhdf5 and no h5py, on the CPU and on the card's
machine alike.

Only the part of h5py's interface the port's HDF5 sites use:

* ``File(path, mode)`` with modes ``r``, ``w`` and ``a``, a context manager;
* ``Group``: ``create_group``, ``create_dataset(name, shape=, dtype=, data=,
  maxshape=, chunks=, compression=)``, ``g[name]`` (paths with ``/``),
  ``g[name] = value`` (an array, a numpy scalar, a ``str``, a list of
  ``bytes`` or ``str``), ``in``, ``len``, ``keys``, ``items`` and iteration in
  the order of the names' bytes, as h5py iterates;
* ``Dataset``: ``shape``, ``dtype``, ``chunks``, ``maxshape``, reads and
  writes of ``()``, ``...``, integers, slices with a
  positive step and sorted integer arrays, ``resize(n, axis=)`` or
  ``resize(shape)``, ``len`` and ``numpy.asarray``.

Reads and writes touch only the chunks (or, for contiguous storage, the rows
along the first axis) a selection covers, as h5py's do.  Values come back as
h5py gives them: the stored dtype (byte order included), ``bool`` for h5py's
boolean enum, ``bytes`` (an object array) for variable-length strings and a
numpy scalar or ``bytes`` for a scalar read with ``[()]``.  As in h5py, a
dataset is chunked (by h5py's chunk rule unless ``chunks`` is given) when it
has a ``maxshape``, ``chunks`` or ``compression="gzip"`` (deflate level 4).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import hdf5_fmt as fmt


def _as_array(value) -> Tuple[np.ndarray, int]:
    """A value to store and its strings' character set (1: UTF-8)."""
    if isinstance(value, str):
        return np.array(value, object), 1
    if isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, (bytes, str)) for v in value):
        arr = np.empty(len(value), object)
        arr[:] = list(value)
        return arr, int(any(isinstance(v, str) for v in value))
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        raise TypeError("numpy unicode arrays have no HDF5 type: store bytes or str objects")
    return arr, 1


def _selection(key, shape: Tuple[int, ...]) -> Tuple[List[np.ndarray], List[bool]]:
    """One sorted index array an axis, and whether the axis is kept (an
    integer drops it)."""
    key = key if isinstance(key, tuple) else (key,)
    if any(k is Ellipsis for k in key):
        i = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1 :]
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for a dataset of rank {len(shape)}")
    key = key + (slice(None),) * (len(shape) - len(key))
    sel, keep = [], []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("a slice step must be positive")
            sel.append(np.arange(start, stop, step, dtype=np.int64))
            keep.append(True)
        elif isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(k)} out of range for an axis of {n}")
            sel.append(np.array([i], np.int64))
            keep.append(False)
        else:
            if np.asarray(k).dtype == bool:
                raise TypeError("boolean masks are not supported: index with sorted integers")
            idx = np.asarray(k, np.int64).reshape(-1)
            if len(idx) and (idx[0] < 0 or idx[-1] >= n or np.any(np.diff(idx) <= 0)):
                raise TypeError("an index array must be increasing and within the axis")
            sel.append(idx)
            keep.append(True)
    return sel, keep


class Dataset:
    """A dataset of an open ``File``."""

    def __init__(self, obj: fmt.DataObj, name: str):
        self._obj, self.name = obj, name

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._obj.shape)

    @property
    def maxshape(self) -> Tuple[Optional[int], ...]:
        return tuple(self._obj.maxshape)

    @property
    def chunks(self) -> Optional[Tuple[int, ...]]:
        return None if self._obj.chunks is None else tuple(self._obj.chunks[:-1])

    @property
    def dtype(self) -> np.dtype:
        return self._obj.type.dtype

    def __len__(self) -> int:
        if not self._obj.shape:
            raise TypeError("a scalar dataset has no len()")
        return self._obj.shape[0]

    def __getitem__(self, key):
        sel, keep = _selection(key, self.shape)
        out = self._obj.read(sel)
        out = out.reshape([len(s) for s, k in zip(sel, keep) if k])
        return out[()] if out.ndim == 0 and key is not Ellipsis else out

    def __setitem__(self, key, value) -> None:
        sel, keep = _selection(key, self.shape)
        arr = _as_array(value)[0] if self._obj.type.kind == "vstr" else np.asarray(value)
        kept = [len(s) for s, k in zip(sel, keep) if k]
        self._obj.write(sel, np.broadcast_to(arr, kept).reshape([len(s) for s in sel]))

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self[...])
        return out if dtype is None else out.astype(dtype)

    def resize(self, size, axis: Optional[int] = None) -> None:
        """``resize(shape)``, or ``resize(n, axis=k)`` for one axis."""
        if axis is None:
            shape = tuple(size)
        else:
            shape = list(self.shape)
            shape[axis] = int(size)
        self._obj.resize(tuple(shape))


class Group:
    """A group of an open ``File``."""

    def __init__(self, h5: fmt.H5File, obj: fmt.GroupObj, name: str):
        self._h5, self._obj, self.name = h5, obj, name

    def _wrap(self, obj, name: str):
        return Group(self._h5, obj, name) if isinstance(obj, fmt.GroupObj) else Dataset(obj, name)

    def _walk(self, path: str, create: bool = False) -> Tuple[fmt.GroupObj, str, str]:
        """The group holding the last part of ``path`` (``create``: making
        the missing groups on the way, as h5py does), that part and the full
        name."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"no member name in {path!r}")
        grp = self._obj
        if path.startswith("/"):
            grp = self._h5.object(self._h5.root_addr)
        for part in parts[:-1]:
            addr = grp.get(part)
            if addr is None and create:
                grp = grp.create_group(part)
                continue
            if addr is None:
                raise KeyError(f"no member {part!r} in {path!r}")
            grp = self._h5.object(addr)
            if not isinstance(grp, fmt.GroupObj):
                raise KeyError(f"{part!r} in {path!r} is not a group")
        base = "" if path.startswith("/") else self.name.rstrip("/")
        return grp, parts[-1], base + "/" + "/".join(parts)

    def __getitem__(self, path: str):
        grp, last, full = self._walk(path)
        addr = grp.get(last)
        if addr is None:
            raise KeyError(f"no member {path!r} in {self._h5.path}")
        return self._wrap(self._h5.object(addr), full)

    def __setitem__(self, path: str, value) -> None:
        self.create_dataset(path, data=value)

    def __contains__(self, path: str) -> bool:
        try:
            grp, last, _ = self._walk(path)
        except (KeyError, ValueError):
            return False
        return grp.get(last) is not None

    def keys(self) -> List[str]:
        return self._obj.names()

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def create_group(self, path: str) -> "Group":
        grp, last, full = self._walk(path, create=True)
        return Group(self._h5, grp.create_group(last), full)

    def create_dataset(self, path: str, shape: Optional[Sequence[int]] = None, dtype=None,
                       data=None, maxshape: Optional[Sequence[Optional[int]]] = None,
                       chunks=None, compression: Optional[str] = None) -> Dataset:
        if compression not in (None, "gzip"):
            raise ValueError(f"compression {compression!r}: only 'gzip' is written")
        cset = 1
        if data is not None:
            data, cset = _as_array(data)
            if dtype is not None and data.dtype != np.dtype(dtype):
                data = data.astype(dtype)
            shape = data.shape if shape is None else tuple(shape)
        if shape is None:
            raise TypeError("create_dataset needs shape= or data=")
        shape = tuple(int(n) for n in shape)
        type_ = fmt.Type.of(data.dtype if data is not None else (dtype or "f4"), cset)
        if maxshape is not None:
            maxshape = tuple(maxshape)
        if chunks is True or (chunks is None and (maxshape is not None or compression)):
            chunks = fmt.guess_chunk(shape, type_.raw.itemsize)
        grp, last, full = self._walk(path, create=True)
        obj = grp.create_dataset(last, shape, type_, maxshape, chunks or None,
                                 fmt.DEFLATE_LEVEL if compression else None)
        ds = Dataset(obj, full)
        if data is not None:
            ds[...] = data
        return ds


class File(Group):
    """An HDF5 file: ``mode`` 'r' (read), 'w' (create or truncate), 'a'
    (read and write, created when missing)."""

    def __init__(self, path, mode: str = "r"):
        h5 = fmt.H5File(path, mode)
        try:
            root = h5.object(h5.root_addr)
        except BaseException:
            h5.close()
            raise
        super().__init__(h5, root, "/")

    def close(self) -> None:
        self._h5.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
