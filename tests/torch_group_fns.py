"""The functions that the process-group tests (``tests/test_torch_group_*``)
run on every rank of a gloo group. A spawned rank imports this module to
find them, so it imports only torch, numpy and ``tpudl_torch``
(``tests/test_torch_boundary.py``'s rule for spawned ``train_fn``s). Each
function runs one scenario and returns what every rank saw, gathered to
rank 0 in rank order, for the parent to hold against tpudl and against
the port's local mesh.

The model is the small LM of the tests: vocab 64, dim 32, 4 heads, 2
layers, tpudl's ``init(0)`` params, and seeded numpy rows of 65 tokens.
"""

import os
import sys

import numpy as np

import torch
import torch.distributed as dist

from tpudl_torch import distributed as D
from tpudl_torch import mesh as M
from tpudl_torch.train import make_train_step, sgd
from tpudl_torch.zoo.transformer import (TinyCausalLM, load_jax_params,
                                         to_jax_params)

ARCH = dict(vocab=64, dim=32, heads=4, layers=2, max_len=96)
LR = 0.1

# a spawned rank imports this module first: one thread a rank keeps its
# CPU sums in one order however loaded the host is (the restart test
# holds two runs to each other bit for bit)
torch.set_num_threads(1)


def tokens(step, b=4, s=65):
    return np.random.default_rng(step).integers(
        0, ARCH["vocab"], size=(b, s)).astype(np.int32)


def lm(device, experts=0):
    net = TinyCausalLM(**ARCH, experts=experts, device=device)
    return load_jax_params(net, net.init(0))


def gathered(obj):
    """``obj`` of every rank of the world, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _tp(mesh) -> bool:
    return mesh.shape["model"] > 1


def forward_fn(ctx):
    """The dense model and the MoE model (experts=4) over the rank's grid:
    each rank's hidden states, logits, routing, loss and the bytes of its
    split leaves (the whole leaves' bytes beside them), and the jax,
    tpudl, ml_dtypes and keras modules it holds (none)."""
    mesh, tp = ctx.mesh, _tp(ctx.mesh)
    t = torch.from_numpy(tokens(0))
    out = {"coords": mesh.coords, "size": ctx.size, "rank": ctx.rank,
           "loaded": sorted(m for m, mod in sys.modules.items()
                            if mod is not None and m.split(".")[0]
                            in ("jax", "tpudl", "ml_dtypes", "keras"))}
    for experts in (0, 4):
        net = lm(ctx.device, experts)
        names = net._split_names()
        whole = sum(p.numel() * p.element_size() for b in net.blocks
                    for k, p in b.items() if k in names)
        net.shard_params(mesh)
        split = sum(p.numel() * p.element_size()
                    for p, _ in net.split_parameters())
        with torch.no_grad():
            net.moe_routes = []
            hidden = net.hidden(t[:, :-1], mesh=mesh, tp=tp)
            logits = net.apply(t[:, :-1], mesh=mesh, tp=tp)
            routes = [c.numpy() for c, _ in net.moe_routes[:ARCH["layers"]]]
            net.moe_routes = None
            loss = net.loss_fn(mesh=mesh, tp=tp)(net, t).item()
        out[experts] = {"hidden": hidden.numpy(), "logits": logits.numpy(),
                        "routes": routes, "loss": loss,
                        "split_bytes": split, "whole_bytes": whole}
    return gathered(out)


def _grads(ctx, experts, remat=False, shard=True):
    """One ``make_train_step`` (sgd at lr 0) of the laid-out model (with
    ``shard=False`` the model as it is built, every leaf whole on every
    rank): the rank's gradients of its own leaves after the data-axis
    reduction, by parameter name, and its split leaves' dims."""
    mesh, tp = ctx.mesh, _tp(ctx.mesh)
    net = lm(ctx.device, experts)
    if shard:
        net.shard_params(mesh)
    step = make_train_step(net.loss_fn(mesh=mesh, tp=tp, remat=remat),
                           mesh=mesh)
    loss = step(net, sgd(0.0)(net.parameters()),
                torch.from_numpy(tokens(0))).item()
    dims = {id(p): d for p, d in net.split_parameters()}
    return {"loss": loss,
            "grads": {n: p.grad.numpy().copy()
                      for n, p in net.named_parameters()},
            "dims": {n: dims[id(p)] for n, p in net.named_parameters()
                     if id(p) in dims}}


def _train(ctx, experts, steps, fail_at=None, save_every=1):
    """``Trainer(param_shardings=)`` (under a model axis) over the rank's
    grid: ``steps`` sgd steps of the LM's ``loss_fn(mesh=, tp=)``. The
    rank's losses, and the whole params after the steps (gathered over
    the rows). ``fail_at`` raises on the last rank at that step on the
    first attempt."""
    mesh, tp = ctx.mesh, _tp(ctx.mesh)
    net = lm(ctx.device, experts)

    def data(step):
        if (fail_at is not None and step == fail_at and ctx.attempt == 0
                and ctx.rank == mesh.world - 1):
            raise RuntimeError(f"injected failure at step {step}")
        return tokens(step)

    trainer = ctx.trainer(net.loss_fn(mesh=mesh, tp=tp), sgd(LR),
                          log_every=1, save_every=save_every,
                          param_shardings=(net.param_shardings(mesh)
                                           if tp else None))
    _, _, hist = trainer.fit(net, data, steps)
    return {"losses": [h["loss"] for h in hist],
            "params": to_jax_params(net)}     # a gather over every row


def train_fn(ctx, experts=0, steps=2, fail_at=None):
    """:func:`_train` on every rank, gathered."""
    out = _train(ctx, experts, steps, fail_at)
    return gathered({"coords": ctx.mesh.coords, "losses": out["losses"],
                     "params": out["params"] if ctx.rank == 0 else None})


def _wrong_batch(ctx):
    """The ring loss's check of its batch: ``whole_batch`` kept through
    ``with_compute_dtype``, and the ``ValueError`` (its message, or None)
    of a ``Trainer`` whose loss is a wrapper that drops it, so that the
    Trainer hands each rank of a column its own rows."""
    from tpudl_torch.train import Trainer, with_compute_dtype

    mesh = ctx.mesh
    net = lm(ctx.device)
    loss = net.loss_fn(mesh=mesh, tp=_tp(mesh))
    out = {"kept": with_compute_dtype(loss, torch.bfloat16).whole_batch}
    try:
        Trainer(lambda model, t: loss(model, t), sgd(LR), mesh=mesh).fit(
            net, tokens, 1)
    except ValueError as e:
        out["raised"] = str(e)
    else:
        out["raised"] = None
    return out


def train_scenario_fn(ctx):
    """The dense model and the MoE model (experts=4) on the rank's grid:
    one step's gradients (also under ``remat=True``, and of the model
    left unsplit) and two Trainer steps each; then the ring loss's check
    of its batch."""
    out = {"coords": ctx.mesh.coords}
    for experts in (0, 4):
        train = _train(ctx, experts, 2, save_every=0)
        grads = _grads(ctx, experts)
        remat = _grads(ctx, experts, remat=True)["grads"]
        out[experts] = {**grads, "losses": train["losses"],
                        "params": train["params"] if ctx.rank == 0 else None,
                        "remat_equal": all(np.array_equal(remat[n], g)
                                           for n, g in grads["grads"].items()),
                        "unsplit": _grads(ctx, experts, shard=False)}
    out["wrong_batch"] = _wrong_batch(ctx)
    return gathered(out)


def grid_report(ctx):
    """Every rank's (rank, ctx.size, coords, mesh shape, device)."""
    mesh = ctx.mesh
    return gathered((ctx.rank, ctx.size, mesh.coords, mesh.shape,
                     str(ctx.device)))


def initialize_entry(rank, world, path, fn, kwargs, out):
    """A rank started by hand: ``initialize`` then ``build_mesh(n_data,
    n_model)`` (the route for users who start their ranks themselves),
    then ``fn(ctx, **kwargs)``; rank 0 writes the result to ``out``."""
    from tpudl_torch.train import TrainContext

    torch.set_num_threads(1)
    D.initialize(f"file://{path}", world, rank, backend="gloo")
    try:
        n_model = kwargs.pop("n_model")
        ctx = TrainContext(M.build_mesh(world // n_model, n_model),
                           checkpoint_dir=kwargs.pop("checkpoint_dir", None))
        result = fn(ctx, **kwargs)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def run_initialized(fn, world, n_model, tmp_path, **kwargs):
    """Start ``world`` gloo ranks that join by :func:`initialize_entry`
    and return rank 0's result of ``fn``."""
    import torch.multiprocessing as mp

    out = os.path.join(tmp_path, "result.pt")
    mp.start_processes(initialize_entry,
                       args=(world, os.path.join(tmp_path, "rdzv"), fn,
                             dict(kwargs, n_model=n_model), out),
                       nprocs=world, start_method="spawn")
    return torch.load(out, weights_only=False)


def collectives_fn(ctx):
    """The collectives of :mod:`tpudl_torch.collectives` on the rank's
    grid, each rank's inputs made from its rank: forward results and the
    gradients that come back, for the parent to hold against plain sums."""
    from tpudl_torch import collectives as C

    from tpudl_torch.attention import ring_attention

    mesh = ctx.mesh
    row = mesh.axis_group("model")
    r = float(ctx.rank)
    x = torch.full((2, 3), r + 1.0, requires_grad=True)
    out = {"coords": mesh.coords}
    y = C.reduce_sum(x, row)
    (y * (r + 1.0)).sum().backward()
    out["reduce_sum"] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    y = C.copy_in(x, row)
    (y * (r + 1.0)).sum().backward()
    out["copy_in"] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    y = C.psum(x, row)
    (y * (r + 1.0)).sum().backward()
    out["psum"] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    y = C.gather(x, row, dim=1)
    (y * torch.arange(y.numel()).view_as(y)).sum().backward()
    out["gather"] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    z = (torch.arange(4.0) + 10 * r).repeat_interleave(3).view(4, 3)
    z.requires_grad_()
    y = C.all_to_all(z, row)
    (y * (r + 1.0)).sum().backward()
    out["all_to_all"] = (y.detach().numpy(), z.grad.numpy().copy())
    # replicate over the data axis from its first entry, and the
    # all-reduces over either axis
    w = torch.full((3,), r)
    M.replicate([w], mesh, M.DATA_AXIS)
    s = torch.full((3,), r)
    M.all_reduce_mean([s], mesh, M.MODEL_AXIS)
    a = torch.full((3,), r)
    M.all_reduce_mean([a], mesh)
    out["replicate"], out["mean_model"], out["mean_data"] = \
        w.numpy(), s.numpy(), a.numpy()
    out["batch"] = M.shard_batch(np.arange(8), mesh).numpy()
    # the causal ring over the data axis, heads split over the model axis
    q, k, v, go = ring_inputs()
    n, i = mesh.shape["data"], mesh.axis_index("data")
    s = q.shape[1] // n
    q, k, v = (t[:, i * s:(i + 1) * s].clone().requires_grad_()
               for t in (q, k, v))
    o = ring_attention(q, k, v, mesh, head_axis="model", causal=True,
                       use_pallas=True)
    (o * go[:, i * s:(i + 1) * s]).sum().backward()
    out["ring"] = (o.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
                   v.grad.numpy())
    return gathered(out)


def ring_inputs():
    """Seeded q, k, v ``[2, 16, 4, 8]`` and an output cotangent."""
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.normal(size=(2, 16, 4, 8))
                                  .astype(np.float32)) for _ in range(4))


def checkpoint_fn(ctx, directory):
    """A model laid out over the grid, one adam step, its state taken by
    the Trainer's ``_state`` on every rank (the split leaves and their
    optimizer state gathered over each row) and saved by rank 0; then
    restored into a fresh model of the same layout by ``_load_state``.
    Returns every rank's own leaves and ``blocks.0.wq``'s optimizer
    state, before the save and as restored."""
    from tpudl_torch.train import CheckpointManager, adam
    from tpudl_torch.train.runner import _load_state, _state

    mesh = ctx.mesh

    def laid_out():
        net = lm(ctx.device).shard_params(mesh)
        return net, adam(1e-2)(net.parameters())

    def leaves(net, opt, i):
        return ({k: v.numpy().copy() for k, v in net.state_dict().items()},
                {k: v.numpy().copy()
                 for k, v in opt.state_dict()["state"][i].items()})

    net, opt = laid_out()
    make_train_step(net.loss_fn(mesh=mesh, tp=True), mesh=mesh)(
        net, opt, torch.from_numpy(tokens(0)))
    state = _state(net, opt, 1, mesh)
    mgr = CheckpointManager(directory)
    if ctx.rank == 0:
        mgr.save(1, state, force=True)
    dist.barrier()
    back, back_opt = laid_out()
    _load_state(back, back_opt, mgr.restore(), mesh)
    wq = [n for n, _ in net.named_parameters()].index("blocks.0.wq")
    mine, mine_opt = leaves(net, opt, wq)
    got, got_opt = leaves(back, back_opt, wq)
    return gathered({"coords": mesh.coords, "params": mine,
                     "opt_wq": mine_opt, "restored": got,
                     "restored_opt_wq": got_opt, "wq": str(wq)})


def mesh_fn(ctx, directory):
    """:func:`collectives_fn` and :func:`checkpoint_fn` in one spawn."""
    return {"collectives": collectives_fn(ctx),
            "checkpoint": checkpoint_fn(ctx, directory)}
