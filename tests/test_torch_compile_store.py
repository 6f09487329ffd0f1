"""tpudl_torch.compile against tpudl.compile: the three knobs' decisions
under the same environment, the copied host logic (the entry checksum
among it), and the program store's behaviour on the CPU, where a program
is the plain function — miss, manifest entry, restore in a fresh store,
foreign and corrupt entries, re-keying, portability, the table's bound,
and a tpudl manifest in the same directory left alone."""

import ast
import json
import os
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tpudl.compile import buckets as jbk
from tpudl.compile import cache as jcache
from tpudl.compile import store as jstore

import tpudl_torch.compile as tcompile
from tpudl_torch.compile import buckets as bk
from tpudl_torch.compile import cache as ccache
from tpudl_torch.compile import store as cstore
from tpudl_torch.obs import metrics as tmetrics

from test_torch_boundary import _COPIED, _code_of

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_stores():
    cstore.reset_program_store()
    jstore.reset_program_store()
    yield
    cstore.reset_program_store()
    jstore.reset_program_store()


def _count(name):
    return tmetrics.counter(name).value


# -- the knobs ---------------------------------------------------------------

@pytest.mark.parametrize("env", [None, "", "0", "off", "none", "1", "true",
                                 "/some/store"])
@pytest.mark.parametrize("kwarg", [None, True, False])
def test_aot_enabled_decides_as_tpudl(monkeypatch, env, kwarg):
    if env is None:
        monkeypatch.delenv("TPUDL_COMPILE_AOT", raising=False)
    else:
        monkeypatch.setenv("TPUDL_COMPILE_AOT", env)
    assert cstore.aot_enabled(kwarg) == jstore.aot_enabled(kwarg)


@pytest.mark.parametrize("aot,cache_dir", [
    ("/some/store", None), ("~/store", "/base"), ("1", "/base"),
    ("true", None), ("1", "0"), ("on", "")])
def test_store_dir_as_tpudl(monkeypatch, aot, cache_dir):
    """Same directory as tpudl wherever the env names one; the default
    base is the port's own (``tpudl_torch/_build``)."""
    monkeypatch.setenv("TPUDL_COMPILE_AOT", aot)
    if cache_dir is None:
        monkeypatch.delenv("TPUDL_COMPILE_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("TPUDL_COMPILE_CACHE_DIR", cache_dir)
    want, got = jstore.store_dir(), cstore.store_dir()
    if want == os.path.join(jcache.DEFAULT_CACHE_DIR, "programs"):
        assert got == os.path.join(ccache.DEFAULT_CACHE_DIR, "programs")
    else:
        assert got == want


@pytest.mark.parametrize("env", [None, "pow2", "pow2ish", "1", "auto",
                                 "off", "0", "8,16,32"])
def test_resolve_ladder_reads_the_env_as_tpudl(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("TPUDL_COMPILE_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("TPUDL_COMPILE_BUCKETS", env)
    want, got = jbk.resolve_ladder(None), bk.resolve_ladder(None)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.spec == want.spec
        assert [got.pick(n) for n in range(1, 70)] == \
            [want.pick(n) for n in range(1, 70)]
        assert got.rungs_up_to(40) == want.rungs_up_to(40)
        assert got.to_meta() == want.to_meta()
    assert bk.resolve_ladder(False) is None   # a kwarg beats the env
    monkeypatch.setenv("TPUDL_COMPILE_BUCKETS", "not-a-ladder")
    with pytest.raises(ValueError):
        bk.resolve_ladder(None)


@pytest.fixture
def jax_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    ccache._reset_for_tests()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    ccache._reset_for_tests()


@pytest.mark.parametrize("env,explicit", [
    ("envdir", "arg"), ("envdir", None), (None, "arg"), ("0", "arg"),
    ("0", None)])
def test_enable_compilation_cache_precedence(tmp_path, monkeypatch,
                                             jax_cache_dir, env, explicit):
    """``0`` kills even an explicit path; an explicit path beats the env,
    which beats the default: the same decision and directory as tpudl."""
    if env is None:
        monkeypatch.delenv("TPUDL_COMPILE_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("TPUDL_COMPILE_CACHE_DIR",
                           env if env == "0" else str(tmp_path / env))
    path = None if explicit is None else str(tmp_path / explicit)
    before = _count("compile.cache_disabled")
    want = jcache.enable_compilation_cache(path)
    got = ccache.enable_compilation_cache(path)
    assert got == want
    assert _count("compile.cache_disabled") == before   # silent
    if got is not None:
        assert (tmp_path / explicit if explicit else
                tmp_path / env).joinpath("kernels").is_dir()


def test_enable_compilation_cache_default_and_failure(tmp_path, monkeypatch,
                                                      jax_cache_dir):
    monkeypatch.delenv("TPUDL_COMPILE_CACHE_DIR", raising=False)
    assert ccache.enable_compilation_cache() == ccache.DEFAULT_CACHE_DIR
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where a directory is needed")
    bad = str(blocker / "sub")
    jcache._reset_warned_for_tests()
    before = _count("compile.cache_disabled")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert jcache.enable_compilation_cache(bad) is None
        assert ccache.enable_compilation_cache(bad) is None
        assert ccache.enable_compilation_cache(bad) is None
    ours = [w for w in rec if "kernel-build cache DISABLED"
            in str(w.message)]
    assert len(ours) == 1 and ours[0].category is RuntimeWarning
    assert _count("compile.cache_disabled") == before + 2


def test_exports_tpudls_names():
    from tpudl import compile as jcompile

    assert tcompile.__all__ == jcompile.__all__
    for name in tcompile.__all__:
        assert hasattr(tcompile, name)
    assert cstore.MANIFEST_NAME != jstore.MANIFEST_NAME
    assert cstore.MANIFEST_SCHEMA != jstore.MANIFEST_SCHEMA


# -- copied host logic -------------------------------------------------------

def test_copied_blocks_equal_their_tpudl_source():
    """Every ``# copied from tpudl/compile/...`` block of the port's
    compile package is its source's code, docstrings aside."""
    checked = []
    for sub in ("buckets.py", "cache.py", "store.py"):
        path = REPO / "tpudl_torch" / "compile" / sub
        text = path.read_text()
        ours = ast.parse(text)
        for src, qual, branch in _COPIED.findall(text):
            theirs = ast.parse((REPO / src).read_text())
            assert _code_of(ours, qual, branch or None) == _code_of(
                theirs, qual, branch or None), f"{sub}:{qual} drifted"
            checked.append(f"{sub}:{qual}")
    assert len(checked) == 8, checked


def _entry(**extra):
    return {"fn": "ab" * 20, "tree": "(*)",
            "leaves": [[[8, 4], "float32", "cuda", None]],
            "flags": {"matmul_tf32": False, "cudnn_tf32": True,
                      "cudnn_deterministic": False},
            "micro": 1, "bound": False, "portable": True, "bucketed": True,
            "mesh": None, "outputs": [1, True], "program": None,
            "backend": {"platform": "cuda", "device_kind": "NVIDIA H100",
                        "n_devices": 1, "torch": "2.x", "cuda": "12.x",
                        "capability": [9, 0]},
            "created_ts": 1.5, "capture_s": None, **extra}


@pytest.mark.parametrize("extra", [{}, {"crc": 7}, {"mesh": "mesh[('data', "
                                                    "2), ('model', 1)]"}])
def test_entry_crc_equals_tpudls(extra):
    e = _entry(**extra)
    assert cstore._entry_crc(e) == jstore._entry_crc(e)


# -- the store on the CPU ----------------------------------------------------

def _fn(w):
    def f(x):
        return x * w + 1.0
    return f


def test_miss_records_then_a_fresh_store_restores(tmp_path):
    root = tmp_path / "s"
    st = cstore.ProgramStore(str(root))
    f = _fn(torch.full((4,), 3.0))
    x = torch.arange(8.0).reshape(2, 4)
    h0, m0 = _count("compile.hits"), _count("compile.misses")
    out = st.call(f, (x,))
    assert _count("compile.misses") == m0 + 1
    assert torch.equal(st.call(f, (x,)), out)
    assert _count("compile.hits") == h0 + 1
    (key, e), = st.entries().items()
    assert e["portable"] and e["crc"] == cstore._entry_crc(e)
    assert e["leaves"] == [[[2, 4], "float32", "cpu", None]]
    assert e["backend"]["platform"] == "cpu"
    on_disk = json.loads((root / cstore.MANIFEST_NAME).read_text())
    assert on_disk["schema"] == cstore.MANIFEST_SCHEMA
    assert set(on_disk["entries"]) == {key}
    r0 = _count("compile.programs_restored")
    st2 = cstore.ProgramStore(str(root))
    assert st2.programs() == 0
    assert st2.ensure_restored(f, block=True) == 1
    assert _count("compile.programs_restored") == r0 + 1
    h1 = _count("compile.hits")
    assert torch.equal(st2.call(f, (x,)), out)
    assert _count("compile.hits") == h1 + 1
    assert st2.ensure_restored(f, block=True) == 0   # already held


def test_foreign_backend_and_corrupt_entries_are_skipped(tmp_path):
    root = tmp_path / "s"
    st = cstore.ProgramStore(str(root))
    f, g = _fn(torch.ones(4)), _fn(torch.full((4,), 2.0))
    st.call(f, (torch.ones(3, 4),))
    st.call(g, (torch.ones(3, 4),))
    path = root / cstore.MANIFEST_NAME
    m = json.loads(path.read_text())
    ef, eg = (next(k for k, e in m["entries"].items()
                   if e["fn"] == cstore.fn_fingerprint(fn)[0])
              for fn in (f, g))
    m["entries"][ef]["backend"] = _entry()["backend"]     # another backend
    m["entries"][ef]["crc"] = cstore._entry_crc(m["entries"][ef])
    m["entries"][eg]["leaves"][0][0] = [9, 9]              # torn: crc stale
    path.write_text(json.dumps(m))
    c0 = _count("compile.store_corrupt")
    st2 = cstore.ProgramStore(str(root))
    assert st2.ensure_restored(f, block=True) == 0
    assert st2.ensure_restored(g, block=True) == 0
    assert _count("compile.store_corrupt") >= c0 + 1


def test_corrupt_manifest_is_quarantined(tmp_path):
    root = tmp_path / "s"
    cstore.ProgramStore(str(root)).call(_fn(torch.ones(4)),
                                        (torch.ones(2, 4),))
    path = root / cstore.MANIFEST_NAME
    path.write_text("{ torn json")
    c0 = _count("compile.store_corrupt")
    st = cstore.ProgramStore(str(root))
    assert st.entries() == {}
    assert path.with_name(path.name + ".corrupt").exists()
    assert _count("compile.store_corrupt") == c0 + 1


def test_changed_host_closures_rekey_and_token_wins():
    a, b = _fn(np.ones(4, np.float32)), _fn(np.full(4, 2.0, np.float32))
    assert cstore.fn_fingerprint(a)[0] != cstore.fn_fingerprint(b)[0]
    a2 = _fn(np.ones(4, np.float32))
    assert cstore.fn_fingerprint(a)[0] == cstore.fn_fingerprint(a2)[0]
    t1, t2 = _fn(torch.ones(4)), _fn(torch.full((4,), 2.0))
    assert cstore.fn_fingerprint(t1)[0] != cstore.fn_fingerprint(t2)[0]
    assert cstore.fn_fingerprint(t1)[1] and cstore.fn_fingerprint(t2)[1]
    a.aot_token = b.aot_token = "model:v1"
    cstore._FP_MEMO.clear()
    assert cstore.fn_fingerprint(a) == cstore.fn_fingerprint(b)
    assert cstore.fn_fingerprint(a)[1]


@pytest.mark.parametrize("what", ["card tensor", "object id"])
def test_card_tensors_and_object_ids_are_not_portable(tmp_path, what):
    """A closure over a tensor off the host (``meta`` stands in for a
    card here) or an object known only by its address gets an entry that
    is not portable, and a fresh store does not restore it."""
    held = (torch.empty(4, device="meta") if what == "card tensor"
            else threading.Lock())

    def make(h):
        def f(x):
            assert h is not None
            return x + 1.0
        return f

    f = make(held)
    fp, portable = cstore.fn_fingerprint(f)
    assert fp is not None and not portable
    st = cstore.ProgramStore(str(tmp_path / "s"))
    st.call(f, (torch.ones(2),))
    (e,) = st.entries().values()
    assert e["portable"] is False
    assert cstore.ProgramStore(str(tmp_path / "s")).ensure_restored(
        f, block=True) == 0


def test_tpudl_manifest_in_the_same_directory_is_untouched(tmp_path):
    root = tmp_path / "shared"
    jst = jstore.ProgramStore(str(root))
    jfn = jax.jit(lambda x: x * 3.0)
    jst.call(jfn, [np.ones((8, 4), np.float32)])
    jst.drain(60)
    jpath = root / jstore.MANIFEST_NAME
    before = jpath.read_bytes()
    st = cstore.ProgramStore(str(root))
    f = _fn(torch.ones(4))
    st.call(f, (torch.ones(8, 4),))
    st.note_ladder(bk.resolve_ladder("pow2"))
    assert cstore.ProgramStore(str(root)).ensure_restored(
        f, block=True) == 1
    assert jpath.read_bytes() == before
    assert len(jstore.ProgramStore(str(root)).entries()) == 1
    assert len(cstore.ProgramStore(str(root)).entries()) == 1


def test_table_is_bounded_and_forget_drops(tmp_path, monkeypatch):
    monkeypatch.setattr(cstore, "PROGRAM_CACHE_SIZE", 3)
    st = cstore.ProgramStore(str(tmp_path / "s"))
    fns = [_fn(torch.full((4,), float(i))) for i in range(5)]
    for f in fns:
        st.call(f, (torch.ones(2, 4),))
    assert st.programs() == 3
    assert st.forget(fns[-1]) == 1 and st.programs() == 2
    del fns[-1]


def test_bound_program_through_the_store(tmp_path):
    """A program over fixed state (the serve engine's) runs in place: the
    first run is a miss that records it, the next a hit."""
    state = (torch.zeros(3), torch.ones(3))

    def step(acc, inc):
        acc.add_(inc)

    prog = cstore.BoundGraph(step, state, restore=())
    st = cstore.ProgramStore(str(tmp_path / "s"))
    m0, h0 = _count("compile.misses"), _count("compile.hits")
    st.run_bound(prog)
    st.run_bound(prog)
    assert torch.equal(state[0], torch.full((3,), 2.0))
    assert (_count("compile.misses"), _count("compile.hits")) == (m0 + 1,
                                                                  h0 + 1)
    (e,) = st.entries().values()
    assert e["bound"] and e["tree"] == "(*,*)"


def test_bound_programs_stay_out_of_the_table(tmp_path, monkeypatch):
    """The engine holds its bound programs: readied ahead of traffic they
    are in the manifest, not in the table, so no eviction can drop one,
    and every later run is a hit."""
    monkeypatch.setattr(cstore, "PROGRAM_CACHE_SIZE", 1)
    st = cstore.ProgramStore(str(tmp_path / "s"))
    state = (torch.zeros(2), torch.ones(2))

    def step(acc, inc):
        acc.add_(inc)

    progs = [cstore.BoundGraph(step, state, restore=()) for _ in range(2)]
    for prog in progs:
        assert st.ready_bound(prog)
    st.call(_fn(torch.ones(2)), (torch.ones(2),))
    assert st.programs() == 1
    m0, h0 = _count("compile.misses"), _count("compile.hits")
    for prog in progs * 2:
        st.run_bound(prog)
    assert (_count("compile.misses"), _count("compile.hits")) == (m0,
                                                                  h0 + 4)
    assert torch.equal(state[0], torch.full((2,), 4.0))
    assert st.programs() == 1


def _flag_entry(root, flags):
    """A manifest of one CPU entry of ``_fn(ones)`` recorded under
    ``flags``; the live function."""
    f = _fn(torch.ones(4))
    saved = cstore._kernel_flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
        cstore.ProgramStore(str(root)).call(f, (torch.ones(2, 4),))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = saved["cudnn_tf32"]
    return f


@pytest.mark.parametrize("cudnn_tf32", [True, False])
def test_restore_never_turns_tf32_on_under_full_f32(tmp_path, monkeypatch,
                                                    cudnn_tf32):
    """A restore runs on a background thread while other threads may be
    inside ``full_f32()``. It must not switch TF32 on under them: an entry
    that wants TF32 is skipped and counted while a block is open, and one
    that wants it off captures inside ``full_f32``."""
    from tpudl_torch.compile import graphs
    from tpudl_torch.device import full_f32

    flags = {"matmul_tf32": False, "cudnn_tf32": cudnn_tf32}
    f = _flag_entry(tmp_path / "s", flags)
    seen = []
    ready = graphs.PlainProgram.ready

    def spy(self, group, warm=True):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return ready(self, group, warm)

    monkeypatch.setattr(graphs.PlainProgram, "ready", spy)
    inside, done = threading.Event(), threading.Event()
    during = []

    def f32_work():
        with full_f32():
            inside.set()
            done.wait(10)
            during.append((torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))

    other = threading.Thread(target=f32_work)
    other.start()
    try:
        assert inside.wait(10)
        s0 = _count("compile.restore_skipped")
        n = cstore.ProgramStore(str(tmp_path / "s")).ensure_restored(
            f, block=True)
        done.set()
    finally:
        done.set()
        other.join(10)
    assert during == [(False, False)]
    assert all(flag == (False, False) for flag in seen)
    if cudnn_tf32:
        assert (n, seen) == (0, [])
        assert _count("compile.restore_skipped") == s0 + 1
    else:
        assert (n, len(seen)) == (1, 1)
        assert _count("compile.restore_skipped") == s0


def test_restore_under_the_process_flags_writes_none():
    """With no ``full_f32`` block open, an entry recorded under the flags
    the process holds restores, and the flags stay as they were; one under
    other flags is skipped."""
    import tempfile

    on = {"matmul_tf32": False, "cudnn_tf32": True}
    other = {"matmul_tf32": True, "cudnn_tf32": True}
    saved = cstore._kernel_flags()
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        fa, fb = _flag_entry(a, on), _flag_entry(b, other)
        try:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True
            assert cstore.ProgramStore(a).ensure_restored(
                fa, block=True) == 1
            assert cstore.ProgramStore(b).ensure_restored(
                fb, block=True) == 0
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (False, True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved["matmul_tf32"]
            torch.backends.cudnn.allow_tf32 = saved["cudnn_tf32"]


def test_kernel_library_names_the_toolkit_without_running_it(
        tmp_path, monkeypatch):
    """A library's name covers the toolkit by a ``stat`` of the resolved
    nvcc (no process at load); an upgraded nvcc names another library, and
    a host without nvcc loads the newest library of the source."""
    from tpudl_torch import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("v1")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.subprocess, "run", None)   # none may start
    name = _build.sources()[0]
    first = _build._target(name, tmp_path)
    assert first == _build._target(name, tmp_path)
    assert first.name.startswith(f"{name}-")
    nvcc.write_text("v2, a longer binary")
    upgraded = _build._target(name, tmp_path)
    assert upgraded != first and upgraded.parent == tmp_path
    upgraded.write_bytes(b"")
    (tmp_path / f"{upgraded.stem}.7.tmp.so").write_bytes(b"")

    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", missing)
    assert _build._target(name, tmp_path) == upgraded


def test_warm_start_unarmed_is_a_no_op(monkeypatch):
    monkeypatch.delenv("TPUDL_COMPILE_AOT", raising=False)
    assert cstore.warm_start() == jstore.warm_start() == 0


def test_signature_holds_the_kernel_flags_and_mesh_token():
    from tpudl_torch import mesh as M

    x = torch.ones(2, 3, dtype=torch.bfloat16)
    mesh = M.build_mesh(2, 1, devices=["cpu"] * 2)
    sig = cstore.signature_of((x, 3), mesh=mesh)
    assert sig["tree"] == "(*,*)"
    assert sig["leaves"] == [[[2, 3], "bfloat16", "cpu",
                              "mesh[('data', 2), ('model', 1)]"],
                             ["value", "3"]]
    flags = sig["flags"]
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not old
        assert cstore.signature_of((x,))["flags"] != flags
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("case", ["zero", "unwritable", "env", "explicit",
                                  "default"])
def test_kernel_dir_follows_the_cache(tmp_path, monkeypatch, case):
    """``_build``'s directory: the default ``_build/``, ``<dir>/kernels``
    under a named cache, a directory of the process's own under ``0`` or
    when the cache cannot be written (warned once, counted)."""
    from tpudl_torch import _build

    ccache._reset_for_tests()
    monkeypatch.delenv("TPUDL_COMPILE_CACHE_DIR", raising=False)
    try:
        if case == "zero":
            monkeypatch.setenv("TPUDL_COMPILE_CACHE_DIR", "0")
        elif case == "unwritable":
            (tmp_path / "f").write_text("x")
            monkeypatch.setenv("TPUDL_COMPILE_CACHE_DIR",
                               str(tmp_path / "f" / "cache"))
        elif case == "env":
            monkeypatch.setenv("TPUDL_COMPILE_CACHE_DIR", str(tmp_path))
        elif case == "explicit":
            assert ccache.enable_compilation_cache(str(tmp_path / "x"))
        c0 = _count("compile.cache_disabled")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            first, second = _build.build_dir(), _build.build_dir()
        assert first == second
        loud = [w for w in rec if "DISABLED" in str(w.message)]
        if case in ("zero", "unwritable"):
            assert first == Path(ccache._private_dir())
            assert first.is_dir() and first != _build.BUILD_DIR
            assert len(loud) == (1 if case == "unwritable" else 0)
            assert _count("compile.cache_disabled") == c0 + (
                2 if case == "unwritable" else 0)
        elif case == "env":
            assert first == tmp_path / "kernels"
        elif case == "explicit":
            assert first == tmp_path / "x" / "kernels"
        else:
            assert first == _build.BUILD_DIR == Path(
                ccache.DEFAULT_CACHE_DIR)
    finally:
        ccache._reset_for_tests()


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_a_restore_keeps_each_leafs_place_in_its_signature(where):
    """A fused group's microbatches are host tensors the graph copies in,
    so its entry's leaves say ``cpu``; a restore built every leaf on the
    card, its signature missed the entry's, and the first fused transform
    after the manifest held the entry captured its program twice (60
    forward launches instead of 48, chip_smoke phase 21). ``meta`` stands
    in for the card."""
    like = (torch.zeros(4, 3, dtype=torch.int32, device=where),
            torch.ones(4, dtype=torch.float32, device=where))
    sig = cstore.signature_of(like)
    again = cstore._zeros_of(sig["leaves"], torch.device("meta"))
    assert cstore.signature_of(again) == sig


def test_a_cards_program_is_one_program_with_or_without_its_index(
        tmp_path, monkeypatch):
    """The executor's fused dispatch keys its card as ``cuda``
    (``resolve_device``), a restore from the manifest as ``cuda:0``:
    before the key named the index, the two were two programs (phase 21
    on the card: 2 captures of one identity where 1 was due). Held here
    with the card's identity stood in."""
    for name, value in (("current_device", lambda: 0),
                        ("get_device_name", lambda i=None: "card"),
                        ("device_count", lambda: 1),
                        ("get_device_capability", lambda i=None: (9, 0))):
        monkeypatch.setattr(torch.cuda, name, value)
    cstore._backend.cache_clear()
    try:
        store = cstore.ProgramStore(str(tmp_path))

        def fn(x):
            return x * 2

        like = (torch.zeros(4, 2),)
        bare, _ = store._find(fn, None, like, 4, torch.device("cuda"), None)
        indexed, _ = store._find(fn, None, like, 4,
                                 torch.device("cuda", 0), None)
        assert bare.tkey == indexed.tkey
        assert bare.device == torch.device("cuda", 0)
    finally:
        cstore._backend.cache_clear()
