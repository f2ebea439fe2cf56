"""Index + durable storage (port of dawnsearch_tpu/index).

The device index is a FlatIndex (index/flat.py) or, sharded over a mesh,
a ShardedFlatIndex (parallel/sharded_index.py); the SQLite page store
(index/store.py) is the source of truth either is rebuilt from.
"""

from __future__ import annotations


def _filtered(cls, kwargs: dict) -> dict:
    """Keep only the kwargs the index class's constructor accepts: the
    snapshot's kind can differ from the config's (index_kind changed
    between runs), and a stray kwarg must not turn a loadable snapshot
    into a rebuild from the store."""
    import inspect

    params = set(inspect.signature(cls.__init__).parameters)
    return {k: v for k, v in kwargs.items() if k in params}


def load_index(path: str, **kwargs):
    """Load a flat or sharded .npz snapshot written by either package.
    `kwargs` carry the node's index configuration (max_capacity, exact,
    device, mesh, ...): snapshots store data, not policy. Snapshots of the
    retired IVF/auto tiers raise, and the provider then rebuilds from the
    page store.

    `_sharded_loader` (a crew leader, parallel/multihost.py) replaces
    ShardedFlatIndex.load so the followers learn of the load before it
    runs; a non-sharded snapshot is refused in that mode, and the
    provider rebuilds through its factory."""
    import numpy as np

    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    sharded_loader = kwargs.pop("_sharded_loader", None)
    with np.load(path, allow_pickle=False) as z:
        names = set(z.files)
        kind = str(z["kind"]) if "kind" in names else None
    if sharded_loader is not None and kind != "sharded":
        raise ValueError(f"multihost mode serves sharded snapshots only (got "
                         f"kind={kind!r}); rebuilding")
    if kind == "sharded":
        skw = _filtered(ShardedFlatIndex, kwargs)
        if sharded_loader is not None:
            return sharded_loader(path, skw)
        return ShardedFlatIndex.load(path, **skw)
    if kind is not None or "centroids" in names:
        raise ValueError(f"snapshot kind {kind or 'ivf'!r} is not served by "
                         "this port (the provider rebuilds from the page store)")
    return FlatIndex.load(path, **_filtered(FlatIndex, kwargs))
