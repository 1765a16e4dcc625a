"""Train step builders (``repro.launch.train``).

The training loop is the Bismarck UDA: the step function is the
``transition`` (one microbatch-accumulated IGD step), and local SGD
defers the merge of per-pod models to every H steps (the paper's
shared-nothing model averaging at pod granularity).

  * ``make_train_step``    — synchronous minibatch SGD;
  * ``make_localsgd_step`` — per-pod model instances that train
                             independently and average every H steps.

Differences in form, not in numbers:

* the gradient comes from ``torch.autograd`` (``loss.backward()``): the
  params' leaves are made to require grad, the microbatches' gradients
  accumulate in ``.grad`` (the first microbatch's gradient, then
  ``acc + g``: the reference's order from its zero start), then are
  divided by ``grad_accum``. A separate float32 accumulator would cost
  another params-sized buffer (12.85 GB at llama3.2-3b's width), which
  with AdamW's moments would not fit one 80 GB card;
* the optimizer updates the params and its state in place
  (``optim.sgd``), and ``.grad`` is dropped after the update;
* on one card the local-SGD pod bank is a leading dimension and the pods
  step one after another, which is the reference's ``vmap``.

Sharded (``param_shardings``, from ``dist.sharding.shardings``): the
params and optimizer state are DTensors placed by their specs
(``dist.sharding.distribute``), the batch is a DTensor placed by
``batch_specs``, and DTensor's propagation takes GSPMD's place: a matmul
over a sharded contraction dim all-reduces, a gather all-gathers. The
step runs under ``implicit_replication``, so the tensors the model makes
on the spot (RoPE angles, positions, the step size) count as replicated.
Attention runs on each rank's local heads (``sharding.head_local``). The
bf16 cast keeps each parameter's placements, as the reference's
``with_sharding_constraint`` does; then each parameter's shards over the
data axes are gathered for use (``sharding.gather_data_axes``, FSDP's
gather), so every matmul sees the batch on the data axes and only the
"model" split is left to DTensor. Each gradient is redistributed to
its parameter's placements after every backward, so ``.grad``
accumulation and the in-place optimizer keep the layout. The metrics come
back as plain replicated tensors. A batch sharded over the data axes
splits into microbatches by a reshape that keeps each rank's rows, so
``global_batch / grad_accum`` must divide by the data axes' size (some
torch releases refuse the reshape otherwise).
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map
from repro_torch.dist import sharding as shd
from repro_torch.models import lm


def _microbatch(batch, accum: int):
    """[B, ...] -> [accum, B/accum, ...], the reference's strided split
    (reshape [B/accum, accum], then swap): microbatch i takes rows i,
    i + accum, i + 2 accum, ..."""
    return tree_map(lambda x: x.reshape((x.shape[0] // accum, accum) + x.shape[1:]).transpose(0, 1), batch)


def optax_global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def make_train_step(cfg, optimizer, grad_accum: int = 1, compress_grads: bool = False,
                    igd_microsteps: bool = False, cast_bf16: bool = False, param_shardings=None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics {"loss", "grad_norm"}); params and opt_state are the
    given trees, updated in place.

    Two microbatching modes, as the reference's:
    * accumulate (default) — float32 gradients summed over ``grad_accum``
      microbatches, one optimizer step;
    * ``igd_microsteps`` — one optimizer step per microbatch, at step index
      ``step * grad_accum + i`` (the paper's per-block IGD transition).

    ``compress_grads`` rounds the gradients through bf16. ``cast_bf16``
    casts the float32 params to bf16 before the forward; the gradients
    reach the float32 masters through the cast.

    ``param_shardings`` (a tree of ``dist.sharding.Sharding`` like the
    params): the step takes DTensor params, state and batch laid out by
    them (see the module's docstring) and returns DTensors in the same
    placements."""
    sharded = param_shardings is not None

    def loss_and_grads(params, mb):
        """The microbatch's loss (detached); its gradient added into each
        param's ``.grad``."""
        fwd = params
        if cast_bf16:  # a DTensor's cast keeps its placements
            fwd = tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p, params)
        if sharded:  # after the cast: the gathers move bf16, as the reference's do
            fwd = tree_map(shd.gather_data_axes, fwd)
        loss, _ = lm.train_loss(fwd, mb, cfg)
        loss.backward()
        if sharded:
            for p in leaves(params):
                if p.grad is not None and tuple(p.grad.placements) != tuple(p.placements):
                    p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        return loss.detach()

    def grads_of(params):
        return tree_map(lambda p: p.grad, params)

    def round_bf16(grads):
        tree_map(lambda g: g.copy_(g.to(torch.bfloat16)), grads)

    def train_step(params, opt_state, batch, step):
        if not sharded:
            return run_step(params, opt_state, batch, step)
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            params, opt_state, metrics = run_step(params, opt_state, batch, step)
        return params, opt_state, {k: shd.full(v) for k, v in metrics.items()}

    def run_step(params, opt_state, batch, step):
        step = int(step)
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
            p.grad = None
        mbs = _microbatch(batch, grad_accum)
        mb_at = [tree_map(lambda x, i=i: x[i], mbs) for i in range(grad_accum)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        if igd_microsteps:
            for i, mb in enumerate(mb_at):
                loss_sum = loss_sum + loss_and_grads(params, mb)
                grads = grads_of(params)
                if compress_grads:
                    round_bf16(grads)
                params, opt_state = optimizer.update(params, grads, opt_state, step * grad_accum + i)
                for p in ps:
                    p.grad = None
            metrics = {"loss": loss_sum / grad_accum, "grad_norm": torch.zeros((), device=loss_sum.device)}
            return params, opt_state, metrics
        for mb in mb_at:
            loss_sum = loss_sum + loss_and_grads(params, mb)
        grads = grads_of(params)
        with torch.no_grad():
            tree_map(lambda g: g.div_(grad_accum), grads)
            if compress_grads:
                round_bf16(grads)
            grad_norm = optax_global_norm(grads)
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        for p in ps:
            p.grad = None
        return params, opt_state, {"loss": loss_sum / grad_accum, "grad_norm": grad_norm}

    return train_step


def make_localsgd_step(cfg, optimizer, grad_accum: int = 1, merge_period: int = 16):
    """Local SGD across the pod axis (the paper's pure-UDA merge at scale).

    The params and optimizer-state banks carry a leading ``n_pods``
    dimension; each pod's instance takes its own step on its own batch
    (``batch_bank`` leaves [n_pods, B, ...]), and at every step with
    ``step % merge_period == merge_period - 1`` the instances are
    replaced by their mean (the UDA ``merge``). Metrics are the pods' mean."""
    base_step = make_train_step(cfg, optimizer, grad_accum)

    def step_fn(params_bank, opt_bank, batch_bank, step):
        n_pods = leaves(params_bank)[0].shape[0]
        per_pod = []
        for i in range(n_pods):
            p = tree_map(lambda x: x[i].detach().clone(), params_bank)
            o = tree_map(lambda x: x[i].clone(), opt_bank)
            p, o, metrics = base_step(p, o, tree_map(lambda x: x[i], batch_bank), step)
            with torch.no_grad():
                tree_map(lambda bank, x: bank[i].copy_(x), params_bank, p)
                tree_map(lambda bank, x: bank[i].copy_(x), opt_bank, o)
            per_pod.append(metrics)
        if int(step) % merge_period == merge_period - 1:
            with torch.no_grad():
                tree_map(lambda t: t.copy_(torch.mean(t, dim=0, keepdim=True).expand_as(t)), params_bank)
        metrics = {k: torch.stack([m[k] for m in per_pod]).mean(0) for k in per_pod[0]}
        return params_bank, opt_bank, metrics

    return step_fn


def replicate_for_pods(tree, n_pods: int):
    """The local-SGD param bank: each leaf repeated along a new leading
    ``n_pods`` dimension (a copy per pod)."""
    return tree_map(lambda x: x.detach()[None].expand((n_pods,) + tuple(x.shape)).clone(), tree)
