"""Mixture-of-Experts: top-k routing with a fixed expert capacity, and the
routed SwiGLU feed-forward.

Counterpart of :mod:`accelerate_tpu.ops.moe`, with its semantics step for
step: ``num_selected`` rounds, each taking the ``argmax`` of the router
probabilities still remaining (the first index on a tie); a token's slot
is its place in its expert's queue, counted in token order and offset by
the slots earlier rounds filled; a choice at or past ``capacity`` is
dropped, and its expert still leaves the remaining set. The combine
weights are the chosen probabilities, divided by the mass of the kept
choices under ``norm_topk`` (floored at 1e-9, so a token whose choices
all dropped gets a zero output and keeps only its residual). The aux
loss is ``E * sum(frac * mean_prob)`` over the top-1 argmax.

The JAX package dispatches with a one-hot ``[tokens, experts, capacity]``
mask and einsums. :func:`top_k_routing` returns that mask and its combine
weights, as the reference does; :func:`moe_ffn` routes on index tensors
instead (``[num_selected, tokens]`` slot ids and their inverse, each
slot's assignment): each dispatch einsum sums exactly one term (or none),
so gathers give the same values, and the card never holds the ``[T, E,
C]`` tensors. Both directions of both the dispatch and the combine are
gathers (:class:`_Dispatch`, :class:`_Combine`): every dropped choice
points at one sink row, and a scatter there (or a sort-based
deterministic scatter) would serialise on it. The combine sums each
token's ``num_selected`` weighted expert rows in one contraction in the
stream dtype, and a token's dispatch gradient sums its rows in f32, as
the reference's einsums do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


class Routing(NamedTuple):
    """One row per round: ``choice`` (the expert), ``position`` (the place in
    its queue), ``keep`` (``position < capacity``) and ``weight`` (the
    combine weight, 0 where dropped), all ``[num_selected, T]``; ``aux`` the
    load-balance loss."""

    choice: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor


def route(router_logits: torch.Tensor, num_selected: int, capacity: int, norm_topk: bool = True) -> Routing:
    """The reference's routing rounds on ``router_logits [T, E]`` (softmax in
    f32), kept per assignment."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    remaining = probs
    experts = torch.arange(e, device=probs.device)[:, None]
    fill = torch.zeros(e, 1, dtype=torch.int64, device=probs.device)  # slots taken by earlier rounds
    selected_mass = torch.zeros(t, dtype=torch.float32, device=probs.device)
    choices, positions, keeps, gates = [], [], [], []
    for _ in range(num_selected):
        choice = torch.argmax(remaining, dim=-1)  # [T]; the first index on a tie
        onehot = experts == choice  # [E, T]: the token axis innermost, so the count is a row scan
        pos = ((onehot.long().cumsum(1) - 1) + fill).gather(0, choice[None])[0]
        keep = pos < capacity
        gate = remaining.gather(1, choice[:, None])[:, 0]  # this choice's probability
        selected_mass = selected_mass + gate * keep
        fill = fill + (onehot & keep).sum(1, keepdim=True)
        remaining = remaining.masked_fill(onehot.T, 0.0)  # the chosen expert leaves the remaining set
        choices.append(choice)
        positions.append(pos)
        keeps.append(keep)
        gates.append(gate * keep)
    weight = torch.stack(gates)
    if norm_topk:
        weight = weight / torch.clamp_min(selected_mass, 1e-9)
    frac = F.one_hot(torch.argmax(probs, dim=-1), e).float().mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    return Routing(torch.stack(choices), torch.stack(positions), torch.stack(keeps), weight, aux)


def top_k_routing(router_logits: torch.Tensor, num_selected: int, capacity: int, norm_topk: bool = True):
    """``(dispatch bool [T, E, C], combine f32 [T, E, C], aux_loss)``, the
    reference's dense form: token ``t`` occupies slot ``c`` of expert ``e``
    in ``dispatch``, with its routing weight in ``combine``."""
    t, e = router_logits.shape
    r = route(router_logits, num_selected, capacity, norm_topk)
    tokens = torch.arange(t, device=r.choice.device).expand_as(r.choice)
    slot = (tokens, r.choice, r.position.clamp(0, capacity - 1))  # a dropped choice adds 0 at its clipped slot
    combine = torch.zeros(t, e, capacity, dtype=torch.float32, device=r.weight.device)
    combine = combine.index_put(slot, r.weight, accumulate=True)
    taken = torch.zeros(t, e, capacity, dtype=torch.int64, device=r.weight.device)
    dispatch = taken.index_put(slot, r.keep.long(), accumulate=True) > 0
    return dispatch, combine, r.aux


def _pad(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one zero row after its rows: the row a sentinel index reads."""
    return torch.cat([x, x.new_zeros(1, *x.shape[1:])])


class _Dispatch(torch.autograd.Function):
    """``xe[s] = x[token of slot s]`` (zero for an empty slot) from ``x [T,
    d]``, ``assign [S]`` (the assignment ``r * T + t`` in slot ``s``, or ``k
    * T``) and ``slot [k, T]`` (each assignment's slot, or ``S``). The
    gradient of token ``t`` sums the rows of its kept slots in f32."""

    @staticmethod
    def forward(ctx, x, assign, slot):
        k, t = slot.shape
        ctx.save_for_backward(slot)
        token = torch.where(assign < k * t, assign % t, t)
        return _pad(x).index_select(0, token)

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        k, t = slot.shape
        rows = _pad(grad).index_select(0, slot.reshape(-1)).view(k, t, -1)
        return rows.sum(0, dtype=torch.float32).to(grad.dtype), None, None


class _Combine(torch.autograd.Function):
    """``out[t] = sum_r weight[r, t] * ye[slot[r, t]]`` from ``ye [S, d]``
    and ``weight [k, T]``, in ``ye``'s dtype; the gradient of slot ``s``'s
    row is its one assignment's weight times that token's output gradient."""

    @staticmethod
    def forward(ctx, ye, weight, slot, assign):
        k, t = slot.shape
        ctx.save_for_backward(ye, weight, slot, assign)
        return torch.einsum("kt,ktd->td", weight, _pad(ye).index_select(0, slot.reshape(-1)).view(k, t, -1))

    @staticmethod
    def backward(ctx, grad):
        ye, weight, slot, assign = ctx.saved_tensors
        k, t = slot.shape
        rows = _pad(ye).index_select(0, slot.reshape(-1)).view(k, t, -1)
        grad_weight = torch.einsum("ktd,td->kt", rows, grad)
        token = torch.where(assign < k * t, assign % t, t)
        grad_ye = _pad(grad).index_select(0, token) * _pad(weight.reshape(-1, 1)).index_select(0, assign)
        return grad_ye, grad_weight, None, None


def moe_ffn(
    x: torch.Tensor,  # [T, d]
    router_kernel: torch.Tensor,  # [d, E]
    wi: torch.Tensor,  # [E, d, ff] (the up projection with wi_gate)
    wo: torch.Tensor,  # [E, ff, d]
    num_selected: int = 2,
    capacity_factor: float = 1.25,
    wi_gate: Optional[torch.Tensor] = None,  # [E, d, ff] for SwiGLU experts
    activation: Callable = _gelu_tanh,
    norm_topk: bool = True,
):
    """The routed feed-forward: ``(out [T, d], aux_loss)``. The router's
    product is in the stream dtype, its softmax in f32; each expert's
    weights are cast to the stream dtype. Capacity is the reference's
    ``max(1, int(capacity_factor * num_selected * T / E))`` (Python floats)."""
    t, d = x.shape
    e = router_kernel.shape[-1]
    capacity = max(1, int(capacity_factor * num_selected * t / e))
    r = route(x @ router_kernel.to(x.dtype), num_selected, capacity, norm_topk)
    sink = e * capacity  # every dropped choice's slot: a zero row past the experts' slots
    slot = torch.where(r.keep, r.choice * capacity + r.position, sink)  # [k, T]
    n = num_selected * t
    assign = torch.full((sink + 1,), n, dtype=torch.int64, device=x.device)
    assign = assign.index_put_((slot.reshape(-1),), torch.arange(n, device=x.device))[:sink]  # the sink is dropped
    xe = _Dispatch.apply(x, assign, slot).view(e, capacity, d)
    if wi_gate is not None:
        h = F.silu(torch.bmm(xe, wi_gate.to(x.dtype))) * torch.bmm(xe, wi.to(x.dtype))
    else:
        h = activation(torch.bmm(xe, wi.to(x.dtype)))
    ye = torch.bmm(h, wo.to(x.dtype))  # [E, C, d]
    return _Combine.apply(ye.reshape(sink, d), r.weight.to(x.dtype), slot, assign), r.aux


class _Experts(nn.Module):
    """The stacked expert weights, in the reference's layout: ``gate_proj``
    and ``up_proj`` ``[E, d, ff]``, ``down_proj`` ``[E, ff, d]``."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(num_experts, hidden_size, intermediate_size))
        self.up_proj = nn.Parameter(torch.empty(num_experts, hidden_size, intermediate_size))
        self.down_proj = nn.Parameter(torch.empty(num_experts, intermediate_size, hidden_size))


class MoEBlock(nn.Module):
    """Sparse SwiGLU FFN block (Mixtral-style): ``forward(x [B, S, d]) ->
    (out [B, S, d], aux_loss)``. The router is ``router.weight [E, d]``
    (the reference's ``router/kernel`` transposed); its product is a plain
    matmul, as the reference's is. Where the JAX block sows the aux loss
    into ``intermediates``, this one returns it."""

    def __init__(self, hidden_size: int, num_experts: int, intermediate_size: int, num_selected: int = 2,
                 capacity_factor: float = 1.25, norm_topk: bool = True):
        super().__init__()
        self.num_selected, self.capacity_factor, self.norm_topk = num_selected, capacity_factor, norm_topk
        self.router = nn.Linear(hidden_size, num_experts, bias=False)
        self.experts = _Experts(num_experts, hidden_size, intermediate_size)

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        ex = self.experts
        out, aux = moe_ffn(
            x.reshape(b * s, d), self.router.weight.T, ex.up_proj, ex.down_proj, num_selected=self.num_selected,
            capacity_factor=self.capacity_factor, wi_gate=ex.gate_proj, norm_topk=self.norm_topk,
        )
        return out.reshape(b, s, d), aux
