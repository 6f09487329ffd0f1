"""JobSpec: the identity of a resumable run.

Copied from ``tpudl/jobs/spec.py``. A job is "the same job" across
process restarts when its spec fingerprints identically: its kind (fit /
estimator_fit / featurize / hpo / custom) and the content identity of
everything that decides its result — the Frame or Dataset fingerprint
(paths, sizes and mtimes of lazy file columns, the codec, the batch
geometry), the model token and the knob dict. A relaunched
:class:`~tpudl_torch.jobs.runtime.JobRuntime` refuses to resume a workdir
whose manifest another fingerprint wrote. A spec's fingerprint, its
``to_json`` and its ``mesh_axes`` equal tpudl's for the same material and
axes; ``mesh_axes`` reads the port's ``Mesh.shape`` (``{"data": rows,
"model": columns}``) for a local mesh and a process group's alike.
Specs are plain JSON (``to_dict``/``from_dict``/``to_json``), so a
scheduler ships one to a fresh process.
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["JobSpec", "fingerprint_material", "mesh_axes"]

KINDS = ("fit", "estimator_fit", "featurize", "hpo", "custom")


# copied from tpudl/jobs/spec.py:mesh_axes
def mesh_axes(mesh) -> dict | None:
    """Canonical JSON form of a job's device topology: ``{axis: size}``
    from a :class:`~tpudl_torch.mesh.Mesh`'s ``shape`` (or a dict already
    in that form), or ``{}`` for an explicitly single-card run. ``None`` = topology
    unknown/unstated (the runtime then records nothing and checks
    nothing — ``run_fit`` derives the real topology from its Trainer).
    Deliberately NOT part of the fingerprint: a topology change is its
    own refusal with its own message (silently resharding a resumed
    sharded checkpoint is the failure this exists to stop)."""
    if mesh is None:
        return None
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in sorted(mesh.items())}
    return {str(k): int(v) for k, v in sorted(dict(mesh.shape).items())}


# copied from tpudl/jobs/spec.py:_canon
def _canon(value):
    """JSON-canonical form of one material value (dicts sorted,
    callables by their cache token — same contract as the shard
    cache's key material)."""
    if isinstance(value, dict):
        return {str(k): _canon(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_canon(v) for v in value]
    if callable(value):
        tok = getattr(value, "cache_token", None)
        if tok:
            return str(tok)
        return "|".join((getattr(value, "__module__", "?"),
                         getattr(value, "__qualname__", repr(value))))
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    return repr(value)


# copied from tpudl/jobs/spec.py:fingerprint_material
def fingerprint_material(*, frame=None, dataset=None, input_cols=None,
                         model=None, knobs=None, **extra) -> dict:
    """Build a spec's material dict from the pipeline objects: the
    Frame answers with its content ``fingerprint`` (lazy columns probe
    paths+sizes+mtimes — no decode), a Dataset contributes its cache
    identity, the model a token/path, ``knobs`` any hyperparameter
    dict. Everything lands as JSON-able values."""
    mat: dict = {}
    if frame is not None:
        mat["frame"] = frame.fingerprint(list(input_cols)
                                         if input_cols else None)
    if dataset is not None:
        cache = getattr(dataset, "cache", None)
        mat["dataset"] = {
            "rows": len(dataset), "batches": dataset.num_batches,
            "cache_key": getattr(cache, "key", None)}
    if model is not None:
        mat["model"] = _canon(model)
    if knobs is not None:
        mat["knobs"] = _canon(knobs)
    for k, v in extra.items():
        mat[k] = _canon(v)
    return mat


# copied from tpudl/jobs/spec.py:JobSpec
class JobSpec:
    """Identity + workdir + resume knobs of one resumable job."""

    def __init__(self, kind: str, workdir: str, *, material: dict | None
                 = None, save_every: int = 100, name: str | None = None,
                 mesh=None):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.kind = str(kind)
        self.workdir = os.path.abspath(str(workdir))
        self.material = _canon(material or {})
        self.save_every = int(save_every)
        self.name = str(name) if name else self.kind
        # the device topology this job runs on (a Mesh, {axis: size}
        # dict, or {} for single-card); None = unstated. The manifest
        # records it and a resume on a DIFFERENT topology is refused
        # (see JobRuntime._begin / mesh_axes above).
        self.mesh_axes = mesh_axes(mesh)

    def fingerprint(self) -> str:
        h = hashlib.sha1()
        h.update(json.dumps({"kind": self.kind, "material": self.material},
                            sort_keys=True).encode())
        return h.hexdigest()

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"kind": self.kind, "workdir": self.workdir,
                "material": self.material, "save_every": self.save_every,
                "name": self.name, "mesh": self.mesh_axes}

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        return cls(d["kind"], d["workdir"], material=d.get("material"),
                   save_every=int(d.get("save_every", 100)),
                   name=d.get("name"), mesh=d.get("mesh"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "JobSpec":
        return cls.from_dict(json.loads(s))

    def __repr__(self) -> str:
        return (f"JobSpec({self.kind!r}, {self.workdir!r}, "
                f"fingerprint={self.fingerprint()[:12]})")
