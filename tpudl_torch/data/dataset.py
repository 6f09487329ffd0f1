"""Dataset facade: epoch iteration with replay over prepared batches.

Port of ``tpudl/data/dataset.py``:

    ds = Dataset(frame, ["image"], batch_size=256,
                 wire_codec="auto", cache_dir="/tmp/tpudl-cache")
    step = ds.wrap(model_fn)
    for epoch in range(3):
        for batch in ds.iter_epoch(epoch):
            step(*batch)

Epoch 0 decodes/packs/encodes each batch (and persists it to the shard
cache when ``cache_dir`` is set); every later epoch — and every later run
over the same inputs — replays memory-mapped shards with zero decodes.
With ``device_cache=True`` the batches become resident on ``device`` as
they first ship, and later epochs hand out the resident tensors: zero
wire bytes. ``Frame.map_batches(wire_codec=..., cache_dir=...)`` runs the
same machinery under the ml stages; this facade is for custom loops (the
estimator's bulk load rides :func:`cached_uri_load`).
"""

from __future__ import annotations

import contextlib

import numpy as np

from tpudl_torch.image.imageIO import _callable_token, _uri_fingerprint

__all__ = ["Dataset", "cached_uri_load", "fetch_batch"]


def fetch_batch(index: int, prepare, *, plan=None, shard_cache=None,
                device_cache=None, run=None, device=None, mesh=None,
                pad=None, report=None, ship: bool = True):
    """One batch through the data layer's lookup chain: the device cache
    (resident tensors; nothing crosses the wire) → the shard cache (a
    memory-mapped read) → ``prepare()`` (pack and encode; persisted when
    a shard cache is set) → resident on ``device`` when the device cache
    admits it, so the bytes cross once. ``Frame.map_batches`` and
    :class:`Dataset` both fetch through here.

    Returns ``(arrays, n_pad, pin)``. ``pin`` is the device cache's
    :class:`~tpudl_torch.data.device_cache.Pin` on the entry whose
    tensors ``arrays`` are, which the caller releases once it is done
    with them; None means ``arrays`` are host numpy. ``run`` is the
    entry's :func:`~tpudl_torch.data.device_cache.run_key`. ``pad(arrays)
    -> (arrays, n_pad)`` runs on a host batch before it is placed (the
    executor's bucket pad). ``report`` (a ``PipelineReport``) gets the
    hit, miss and byte counts. ``ship=False`` is a probe: no wire
    accounting and no placement. With a local ``mesh`` a resident batch
    is held as its per-card shards (one
    :class:`~tpudl_torch.mesh.Sharded` a column); a batch whose rows do
    not split over the mesh stays on the host."""
    from tpudl_torch.data import device_cache as _dc
    from tpudl_torch.data.codec import host_tensor

    def count(name, value=1):
        if report is not None:
            report.count(name, value)

    if device_cache is not None:
        hit = device_cache.get((run, index))
        if hit is not None and (plan is None or plan.resolved()
                                or hit.codecs):
            if plan is not None and not plan.resolved():
                plan.adopt(hit.codecs)
            # resident replay: nothing crosses the wire, so
            # record_shipped is deliberately not called
            count("bytes_hbm_hit", hit.nbytes)
            count("hbm_hits")
            return list(hit.arrays), hit.n_pad, hit
        if hit is not None:
            hit.release()  # unusable hit: its codecs are unknown
    arrays = None
    if shard_cache is not None:
        hit = shard_cache.get(index)
        # an all-hits replay still needs resolved codecs; a cache whose
        # writer died before persisting them re-prepares
        if hit is not None and (plan is None or plan.resolved()):
            count("cache_hits")
            arrays = list(hit)
        else:
            count("cache_misses")
    if arrays is None:
        arrays = list(prepare())
        if shard_cache is not None:
            shard_cache.put(index, arrays)
            if (plan is not None and plan.resolved()
                    and not shard_cache.meta.get("codecs")):
                shard_cache.set_meta({"codecs": plan.keys()})
    if not ship:
        return arrays, 0, None
    if plan is not None:
        plan.record_shipped(arrays)
    count("bytes_prepared", int(sum(int(a.nbytes) for a in arrays)))
    n_pad = 0
    if pad is not None:
        arrays, n_pad = pad(arrays)
    splits = (mesh is None or not arrays
              or int(arrays[0].shape[0]) % mesh.size == 0)
    if device_cache is not None and splits and device_cache.would_fit(
            sum(int(a.nbytes) for a in arrays), run=run):
        import torch

        dev = torch.device(device) if mesh is None else mesh.device
        with (report.stage("h2d") if report is not None
              else contextlib.nullcontext()):
            host = [host_tensor(a, pin=dev.type == "cuda") for a in arrays]
            placed = (_dc.place(host, dev) if mesh is None
                      else _dc.place_sharded(host, mesh))
        if placed is not None:
            codecs = (plan.keys() if plan is not None and plan.resolved()
                      else None)
            pin = device_cache.put((run, index), placed, n_pad=n_pad,
                                   codecs=codecs)
            if pin is not None:
                return list(pin.arrays), n_pad, pin
    return arrays, n_pad, None


# copied from tpudl/data/dataset.py:_loader_token
def _loader_token(loader) -> str:
    """Loader cache identity: :func:`_callable_token` + the declared
    wire attrs (createNativeImageLoader sets an explicit cache_token
    from its geometry/scale/dtype)."""
    tok = getattr(loader, "cache_token", None)
    if tok:
        return str(tok)
    return "|".join([
        _callable_token(loader),
        str(getattr(loader, "output_dtype", "")),
        str(getattr(loader, "wire_scale", "")),
        str(getattr(loader, "wire_offset", "")),
    ])


def cached_uri_load(loader, uris, cache_dir: str, *,
                    chunk: int = 256) -> np.ndarray:
    """``load_uri_batch`` with a sharded on-disk cache: the URI list is
    decoded in ``chunk``-sized shards, each persisted checksummed; a
    repeat call over the same files (estimator re-fit, next epoch of a
    sweep) performs ZERO decodes. Returns one stacked array (float32, or
    uint8 for a loader that declares ``output_dtype='uint8'``). The key is
    tpudl's, so a cache either package filled serves the other."""
    from tpudl_torch.data.shards import ShardCache, cache_key
    from tpudl_torch.ml.image_params import load_uri_batch

    uris = list(uris)
    key = cache_key(_uri_fingerprint(uris), loader=_loader_token(loader),
                    chunk=int(chunk), layout="uri_load_v1")
    cache = ShardCache(cache_dir, key)
    parts = []
    for start in range(0, len(uris), chunk):
        idx = start // chunk
        hit = cache.get(idx)
        if hit is not None:
            parts.append(hit[0])
            continue
        batch = load_uri_batch(loader, uris[start:start + chunk])
        cache.put(idx, [batch])
        parts.append(batch)
    cache.flush()  # persist any throttled manifest entries
    if not parts:
        return load_uri_batch(loader, [])  # canonical empty shape
    if len(parts) == 1:
        return np.array(parts[0])
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


class Dataset:
    """Epoch-replayable prepared-batch view of a Frame's input columns.

    Each yielded batch is the tuple of WIRE-encoded arrays the executor
    would ship (one per column): host numpy, or, with
    ``device_cache=True``, tensors resident on ``device`` (default the
    card). :meth:`device_restore` (host) or :meth:`wrap` (torch, in front
    of a function) restore what the model consumes. With ``cache_dir``,
    batches persist across epochs AND processes; without it, epoch ≥ 1
    replays from memory when ``retain=True`` (default: re-prepare).
    ``device_cache`` is an explicit argument only (a process-wide
    variable must not change what ``get_batch`` returns under host
    consumers), as in tpudl. With ``mesh=`` (a local
    :class:`~tpudl_torch.mesh.Mesh`) a resident batch is held as its
    per-card shards, and ``get_batch`` hands out one
    :class:`~tpudl_torch.mesh.Sharded` a column (the mesh's entries, in
    order; a device consumer runs each entry's shards on its card); the
    key carries the topology, so no other mesh replays them. A ragged tail
    that does not split over the mesh stays a host batch, as in tpudl."""

    def __init__(self, frame, input_cols, *, batch_size: int = 256,
                 wire_codec=None, cache_dir: str | None = None,
                 pack=None, cache_key_material: str | None = None,
                 retain: bool = False, device_cache: bool = False,
                 mesh=None, device="cuda"):
        from tpudl_torch.data import codec as _codec

        if mesh is not None and not mesh.local:
            raise ValueError(
                "Dataset(mesh=) takes a mesh of this process's cards "
                "(tpudl_torch.mesh.build_mesh(devices=[...]))")
        self._mesh = mesh
        self._frame = frame
        self._cols = list(input_cols)
        missing = [c for c in self._cols if c not in frame]
        if missing:
            raise KeyError(f"unknown input columns {missing}")
        self._batch = max(1, int(batch_size))
        self._pack = pack
        self._plan = (_codec.CodecPlan(wire_codec, len(self._cols))
                      if wire_codec is not None else None)
        self._retain = bool(retain) and cache_dir is None
        self._resolving = False  # wrap()'s probe: no wire accounting
        self._memory: dict[int, tuple] = {}
        self._cache = None
        self._dcache = self._dkey = self._device = None
        dc_flag = bool(device_cache)
        if cache_dir is not None or dc_flag:
            from tpudl_torch.data.shards import cache_key

            material = (cache_key_material
                        if cache_key_material is not None
                        else frame.fingerprint(self._cols))
            key = cache_key(material, cols=",".join(self._cols),
                            batch=self._batch,
                            codec=_codec.spec_token(wire_codec),
                            pack=("default" if pack is None
                                  else _callable_token(pack)),
                            layout="dataset_v1")
        if cache_dir is not None:
            from tpudl_torch.data.shards import ShardCache

            self._cache = ShardCache(cache_dir, key)
            if self._plan is not None and self._cache.meta.get("codecs"):
                self._plan.adopt(self._cache.meta["codecs"])
        if dc_flag:
            from tpudl_torch.data import device_cache as _dc
            from tpudl_torch.device import resolve_device

            self._device = resolve_device(
                device if mesh is None else mesh.device)
            self._dkey = _dc.run_key(key, mesh, device=self._device)
            self._dcache = _dc.get_device_cache()

    # -- shape -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._frame)

    @property
    def num_batches(self) -> int:
        return -(-len(self._frame) // self._batch)

    @property
    def cache(self):
        return self._cache

    @property
    def plan(self):
        return self._plan

    # -- prepare one batch -------------------------------------------------
    def _prepare(self, index: int) -> tuple:
        from tpudl_torch.frame.frame import _default_pack

        start = index * self._batch
        stop = min(start + self._batch, len(self._frame))
        arrays = []
        for col, name in enumerate(self._cols):
            sl = self._frame[name][start:stop]
            arr = (self._pack(sl) if self._pack is not None
                   else _default_pack(sl))
            if self._plan is not None:
                arr = self._plan.encode(col, arr)
            arrays.append(arr)
        return tuple(arrays)

    def get_batch(self, index: int) -> tuple:
        """One prepared (encoded) batch by index: device cache (zero wire
        bytes) → shard cache → memory → prepare (+persist
        +make-resident), through :func:`fetch_batch`."""
        def prepare():
            if index in self._memory:
                return self._memory[index]
            batch = self._prepare(index)
            if self._retain:
                self._memory[index] = batch
            return batch

        arrays, _, pin = fetch_batch(
            index, prepare, plan=self._plan, shard_cache=self._cache,
            device_cache=self._dcache, run=self._dkey, device=self._device,
            mesh=self._mesh, ship=not self._resolving)
        if pin is not None:
            # the consumer's own reference keeps the resident tensors
            # alive; the pin only guards an in-flight dispatch
            pin.release()
        return tuple(arrays)

    def iter_epoch(self, epoch: int = 0):
        """Yield every prepared batch in order. ``epoch`` only labels the
        ``data.epoch`` host span: content and order are epoch-invariant
        (shuffling belongs to the consumer)."""
        from tpudl_torch.obs import tracer as _tracer

        with _tracer.span("data.epoch", epoch=int(epoch),
                          batches=self.num_batches):
            try:
                for i in range(self.num_batches):
                    yield self.get_batch(i)
            finally:
                if self._cache is not None:  # persist throttled entries
                    self._cache.flush()

    def epochs(self, n: int):
        for e in range(int(n)):
            yield e, self.iter_epoch(e)

    # -- restore -----------------------------------------------------------
    def device_restore(self, batch: tuple):
        """Host-side restore of one encoded batch (numpy; for host
        consumers and tests). Device consumers :meth:`wrap` their
        function instead."""
        if self._plan is None:
            return batch
        return tuple(
            c.decode_array(_as_numpy(a)) for c, a in zip(
                self._plan.codecs, batch))

    def wrap(self, fn):
        """``fn`` with the codec prologues in front (see
        ``CodecPlan.wrap``: the last ``len(input_cols)`` arguments are
        restored, leading ones such as a model pass through); identity
        when no codec is configured."""
        if self._plan is None:
            return fn
        if not self._plan.resolved():
            # resolve from the first batch so wrap() works before
            # iteration — as a probe: the epoch's own get_batch(0) is the
            # one that counts toward the wire counters
            self._resolving = True
            try:
                self.get_batch(0)
            finally:
                self._resolving = False
        return self._plan.wrap(fn)


def _as_numpy(a) -> np.ndarray:
    """A batch array as numpy (a resident tensor, or a column's per-card
    shards, is copied to the host; bfloat16 comes back as its bits)."""
    import torch

    from tpudl_torch.data.codec import BF16_BITS
    from tpudl_torch.mesh import Sharded

    if isinstance(a, Sharded):
        return np.concatenate([_as_numpy(t) for t in a], axis=0)
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(BF16_BITS)
        return t.numpy()
    return np.asarray(a)
