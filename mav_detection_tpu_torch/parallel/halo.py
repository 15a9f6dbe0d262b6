"""The row-halo exchange shared by every row- or time-sharded path.

Each rank owns a contiguous band of rows (dim ``dim`` of its tensor; the
image rows of a row-sharded solver, the frames of a time chunk). A stencil
near a band's edge reads rows its neighbours own: ``exchange_rows`` returns
the band with ``above`` rows of the rank before it stacked on top and
``below`` rows of the rank after it underneath, in one
``batch_isend_irecv`` round with the two neighbours. At the two global
edges the missing halo has zero rows, so the first and last ranks get a
shorter slab; the caller pads there as its global-edge rule says.

The exchange is differentiable: its backward sends each halo's gradient
back to the rank that owns those rows and adds it to that rank's gradient
of its band (the transpose of the forward's copy).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from mav_detection_tpu_torch.parallel.mesh import Mesh


def _swap(send_up: torch.Tensor, send_down: torch.Tensor, n_from_up: int,
          n_from_down: int, mesh: Mesh, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``send_up`` to the rank before and ``send_down`` to the rank
    after; receive ``n_from_up`` rows from the rank before and
    ``n_from_down`` from the rank after (tensors with zero rows where there
    is no neighbour)."""
    def empty(n: int) -> torch.Tensor:
        shape = list(send_up.shape)
        shape[dim] = n
        return torch.empty(shape, dtype=send_up.dtype, device=send_up.device)

    has_up, has_down = mesh.rank > 0, mesh.rank < mesh.size - 1
    from_up = empty(n_from_up if has_up else 0)
    from_down = empty(n_from_down if has_down else 0)
    ops: List[dist.P2POp] = []
    if has_up:
        up = mesh.peer(mesh.rank - 1)
        if send_up.shape[dim]:
            ops.append(dist.P2POp(dist.isend, send_up.contiguous(), up, mesh.group))
        if n_from_up:
            ops.append(dist.P2POp(dist.irecv, from_up, up, mesh.group))
    if has_down:
        down = mesh.peer(mesh.rank + 1)
        if send_down.shape[dim]:
            ops.append(dist.P2POp(dist.isend, send_down.contiguous(), down, mesh.group))
        if n_from_down:
            ops.append(dist.P2POp(dist.irecv, from_down, down, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_up, from_down


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, above: int, below: int, mesh: Mesh,
                dim: int) -> torch.Tensor:
        ctx.above, ctx.below, ctx.mesh, ctx.dim = above, below, mesh, dim
        n = x.shape[dim]
        if above > n or below > n:
            raise ValueError(f"a halo of {max(above, below)} rows needs bands of "
                             f"at least that many, this one has {n}")
        # the rank before wants my first ``below`` rows, the rank after my
        # last ``above``
        top, bottom = _swap(x.narrow(dim, 0, below), x.narrow(dim, n - above, above),
                            above, below, mesh, dim)
        ctx.got = (top.shape[dim], bottom.shape[dim])
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dim, mesh = ctx.dim, ctx.mesh
        n_top, n_bottom = ctx.got
        total = g.shape[dim]
        g_top = g.narrow(dim, 0, n_top)
        g_bottom = g.narrow(dim, total - n_bottom, n_bottom)
        gx = g.narrow(dim, n_top, total - n_top - n_bottom).clone()
        # my top halo's rows belong to the rank before (its last ``above``),
        # my bottom halo's to the rank after (its first ``below``)
        has_up, has_down = mesh.rank > 0, mesh.rank < mesh.size - 1
        from_up, from_down = _swap(g_top, g_bottom,
                                   ctx.below if has_up else 0,
                                   ctx.above if has_down else 0, mesh, dim)
        n = gx.shape[dim]
        if from_up.shape[dim]:
            gx.narrow(dim, 0, ctx.below).add_(from_up)
        if from_down.shape[dim]:
            gx.narrow(dim, n - ctx.above, ctx.above).add_(from_down)
        return gx, None, None, None, None


def exchange_rows(x: torch.Tensor, above: int, below: int, mesh: Mesh,
                  dim: int = -2) -> torch.Tensor:
    """This rank's band ``x`` with ``above`` rows of the rank before on top
    and ``below`` rows of the rank after underneath, along ``dim`` (the
    rows of a (..., H, W) tensor by default). Zero rows come from beyond
    the global edges. Differentiable; its backward returns each halo's
    gradient to the rank that owns the rows."""
    dim = dim % x.ndim
    if mesh.size == 1:
        return x
    return _ExchangeRows.apply(x, above, below, mesh, dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        from mav_detection_tpu_torch.parallel.mesh import all_gather_cat

        ctx.mesh, ctx.n = mesh, x.shape[-2]
        return all_gather_cat(x.movedim(-2, 0).contiguous(), mesh).movedim(0, -2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from mav_detection_tpu_torch.parallel.mesh import all_reduce_sum_

        # every rank's gradient of the whole image, summed; this rank's rows
        total = all_reduce_sum_(g.contiguous().clone(), ctx.mesh)
        return total.narrow(-2, ctx.mesh.rank * ctx.n, ctx.n).contiguous(), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal bands of rows (dim -2) stacked into the whole image
    on every rank. Differentiable: the backward sums every rank's gradient
    of the image and returns this rank's rows of it."""
    return _GatherRows.apply(x, mesh)


def band(x: torch.Tensor, mesh: Mesh, dim: int = -2) -> torch.Tensor:
    """This rank's contiguous band of a tensor replicated on every rank;
    the size along ``dim`` must divide by the mesh size."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide by {mesh.size} ranks")
    per = n // mesh.size
    return x.narrow(dim, mesh.rank * per, per)


def slab_start(mesh: Mesh, per: int, above: int) -> int:
    """Global row of the first row of this rank's exchanged slab."""
    return mesh.rank * per - (above if mesh.rank > 0 else 0)


def check_exchange(mesh: Mesh, x_full: torch.Tensor, above: int, below: int,
                   weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exchange on this rank's band of a replicated (..., H, W) tensor
    and the gradient, with respect to the band, of ``sum(slab * (rank + 1)
    * w)``, ``w`` the rows of the replicated ``weights`` (shaped like
    ``x_full``) at the slab's global rows. Every rank can compute both from
    the replicated inputs, so ``dryrun_multichip`` and the tests hold them
    to a reference built from the whole tensor."""
    xb = band(x_full, mesh).to(mesh.device).clone().requires_grad_(True)
    slab = exchange_rows(xb, above, below, mesh)
    start = slab_start(mesh, xb.shape[-2], above)
    w = weights.to(mesh.device).narrow(-2, start, slab.shape[-2])
    (slab * (mesh.rank + 1) * w).sum().backward()
    return slab.detach(), xb.grad


def exchange_reference(x_full: torch.Tensor, weights: torch.Tensor, size: int,
                       above: int, below: int):
    """What ``check_exchange`` returns on each of ``size`` ranks, computed
    from the whole tensors in one process: (slabs, band gradients)."""
    n = x_full.shape[-2]
    per = n // size
    slabs, grad = [], torch.zeros_like(x_full)
    for r in range(size):
        lo = r * per - (above if r > 0 else 0)
        hi = (r + 1) * per + (below if r < size - 1 else 0)
        slabs.append(x_full[..., lo:hi, :])
        grad[..., lo:hi, :] += (r + 1) * weights[..., lo:hi, :]
    return slabs, [grad[..., r * per:(r + 1) * per, :] for r in range(size)]
