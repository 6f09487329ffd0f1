"""The port's capture-boundary analyzer (``tpudl_torch.analysis.traceguard``):
tpudl's five trace rules at the CUDA-graph capture, on torch fixtures.

A function is traced when it is handed to ``cuda_ops.capture_graph``,
``FusedGraph``/``BoundGraph``, the program store, or returned by a
stage's ``_device_fn`` builder; each rule fires on its torch fixture and
is quiet on the fix. The real tree's traced roots are the port's capture
entries.
"""

import pytest

from tpudl_torch.analysis import (TRACE_RULES, analyze_trace_sources,
                                  traced_functions)
from tpudl_torch.analysis.checker import _HINTS
from tpudl_torch.analysis.concurrency import read_sources

HEAD = ("import numpy as np\n"
        "import torch\n"
        "from tpudl_torch import cuda_ops\n"
        "from tpudl_torch.compile.graphs import FusedGraph\n"
        "from tpudl_torch.compile.store import get_program_store\n"
        "from tpudl_torch.obs import metrics\n")


def _rules(body: str, rule: str) -> list:
    return [(f.line - HEAD.count("\n"), f.message)
            for f in analyze_trace_sources({"fix.py": HEAD + body},
                                           rules=[rule])]


CASES = {
    "trace-time-effect": (
        "def step(x):\n"
        "    metrics.counter('train.steps').inc()\n"
        "    return x * 2\n"
        "def build(x):\n"
        "    return cuda_ops.capture_graph(step, x.device)\n",
        "def step(x):\n"
        "    return x * 2\n"
        "def build(x):\n"
        "    metrics.counter('train.steps').inc()\n"
        "    return cuda_ops.capture_graph(step, x.device)\n", 2),
    "host-op-on-traced": (
        "def fn(x):\n"
        "    s = x.sum().item()\n"
        "    return x / s\n"
        "def build(x):\n"
        "    return FusedGraph(fn, 4, (x,), 1, x.device)\n",
        "def fn(x):\n"
        "    return x / x.sum()\n"
        "def build(x):\n"
        "    return FusedGraph(fn, 4, (x,), 1, x.device)\n", 2),
    "traced-branch": (
        "def fn(x):\n"
        "    if x.sum() > 0:\n"
        "        return x\n"
        "    return -x\n"
        "def run(x):\n"
        "    return get_program_store().call(fn, (x,))\n",
        "def fn(x):\n"
        "    if x.shape[0] > 1:\n"
        "        x = x[1:]\n"
        "    return torch.where(x.sum() > 0, x, -x)\n"
        "def run(x):\n"
        "    return get_program_store().call(fn, (x,))\n", 2),
    "donation-reuse": (
        "def run(plan, fn, x):\n"
        "    g = plan.wrap(fn, donate=True)\n"
        "    y = g(x)\n"
        "    return y + x.sum()\n",
        "def run(plan, fn, x):\n"
        "    g = plan.wrap(fn, donate=True)\n"
        "    n = x.shape[0]\n"
        "    y = g(x)\n"
        "    return y * n\n", 4),
    "jit-cache-churn": (
        "def run(store, x, k):\n"
        "    return store.call(lambda t: t * k, (x,))\n",
        "def times_two(t):\n"
        "    return t * 2\n"
        "def run(store, x):\n"
        "    return store.call(times_two, (x,))\n", 2),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_each_rule_fires_on_its_torch_fixture_and_not_on_the_fix(rule):
    bad, fixed, line = CASES[rule]
    found = _rules(bad, rule)
    assert [ln for ln, _ in found] == [line], found
    assert _rules(fixed, rule) == []


def test_every_trace_rule_has_a_case_and_a_torch_hint():
    assert set(CASES) == set(TRACE_RULES)
    for rule in TRACE_RULES:
        assert "lax" not in _HINTS[rule]


@pytest.mark.parametrize("call", [
    "cuda_ops.capture_graph(fn, x.device)",
    "FusedGraph(fn, 2, (x,), 1, x.device)",
    "BoundGraph(fn, (x,), ())",
    "get_program_store().call(fn, (x,))",
    "store.fused(fn, fn, [((x,),)], 1, x.device)",
    "store.compile_signature(fn, (x,))",
    "m.map_batches(fn, device_fn=True)",
])
def test_every_capture_entry_marks_its_function(call):
    src = (HEAD + "from tpudl_torch.compile.graphs import BoundGraph\n"
           "def fn(x):\n"
           "    return x * 2\n"
           "def entry(x, store, m):\n"
           f"    return {call}\n")
    traced = traced_functions({"fix.py": src})
    assert "fix:fn" in traced and traced["fix:fn"].kind != "call"


def test_a_stage_builders_returned_function_is_traced():
    src = (HEAD +
           "class Stage:\n"
           "    def _transform(self, net):\n"
           "        def build(device):\n"
           "            def fn(tokens):\n"
           "                n = tokens.max().item()\n"
           "                return tokens * n\n"
           "            return fn\n"
           "        return self._device_fn(('k',), build)\n")
    traced = traced_functions({"fix.py": src})
    assert traced["fix:Stage._transform.build.fn"].kind == "device_fn"
    assert "fix:Stage._transform.build" not in traced
    assert [f.rule for f in analyze_trace_sources({"fix.py": src})] == \
        ["host-op-on-traced"]


def test_a_subscript_store_taints_its_container_not_its_index():
    src = (HEAD +
           "def fn(x, parts):\n"
           "    out = {}\n"
           "    for j in range(2):\n"
           "        out[0, j] = torch.relu(x)\n"
           "        if j == 0:\n"
           "            x = x + 1\n"
           "    return out\n"
           "def build(x):\n"
           "    return cuda_ops.capture_graph(fn, x.device)\n")
    assert analyze_trace_sources({"fix.py": src},
                                 rules=["traced-branch"]) == []


def test_the_ports_roots_are_its_capture_entries():
    sources, modules, errors = read_sources(["tpudl_torch"])
    assert errors == []
    roots = {k for k, v in traced_functions(sources, modules).items()
             if v.kind != "call"}
    assert {"tpudl_torch.compile.graphs:FusedGraph._capture.run",
            "tpudl_torch.compile.graphs:BoundGraph.ready.run",
            "tpudl_torch.ml.lm:LMFeaturizer._transform.build.fn",
            "tpudl_torch.ml.lm:LMClassifier._transform.build.fn",
            "tpudl_torch.ml.named_image:_NamedImageTransformer._batch_fn"
            ".build.fn"} <= roots
