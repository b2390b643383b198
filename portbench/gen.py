"""What the benchmark makes from ``--seed``: weights and frame pools.

Everything is drawn on the run's device by ``torch.Generator``s seeded
from the run's seed and a purpose, in a few large calls.  The same seed
gives the same weights and frames on the same device type.

* :func:`draw_params` — raw parameters of one network in the layout the
  program's ``interpreter.init_params`` returns, with batch-norm
  statistics of both signs and away from the identity, so the folded
  thresholds and directions are exercised.
* :func:`uniform_pool` — batches of uniform b-bit pixels.
* :func:`video_pool` — a vectorised always-on camera trace: per stream a
  static background, and on a fixed share of streams each tick a
  ``patch`` x ``patch`` block at a fresh position shifted by half the
  intensity range (the rest repeat their frame bit for bit).  The pool
  is a cycle: its last tick leads into its first with the same change
  statistics.
* :func:`escalation_pool` — a uniform pool filtered by the reference
  detector's margin, so that exactly a given share of every batch's
  frames reaches the escalation threshold.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Tuple

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}/{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, purpose))
    return g


def draw_params(layers: List[dict], seed: int, purpose: str,
                device) -> Dict[str, list]:
    """Raw parameters of the network ``layers``: conv ``w`` (F, 2, 2, C)
    and batch norm's gamma (|gamma| in [0.5, 1.5), either sign), beta
    (normal, sd 0.5), mean (normal, sd 8) and var (uniform [256, 1600)),
    and FC ``w`` (N, K); latent weights normal, scaled as Glorot."""
    g = generator(seed, purpose, device)
    convs = [ly for ly in layers if ly["kind"] == "conv"]
    fcs = [ly for ly in layers if ly["kind"] == "fc"]
    out = {"conv": [], "fc": []}
    if convs:
        f, c = convs[0]["f"], convs[0]["c"]
        if any((ly["f"], ly["c"]) != (f, c) for ly in convs):
            raise ValueError("conv layers of one network share F and C")
        n = len(convs)
        w = torch.randn((n, f, 2, 2, c), generator=g, device=device)
        w = w / (4 * c) ** 0.5
        u = torch.rand((4, n, f), generator=g, device=device)
        z = torch.randn((2, n, f), generator=g, device=device)
        gamma = (0.5 + u[0]) * torch.where(u[1] < 0.5, -1.0, 1.0)
        var = 256.0 + 1344.0 * u[2]
        for i in range(n):
            out["conv"].append(dict(w=w[i], gamma=gamma[i],
                                    beta=0.5 * z[0, i], mean=8.0 * z[1, i],
                                    var=var[i]))
    for ly in fcs:
        w = torch.randn((ly["n"], ly["k"]), generator=g, device=device)
        out["fc"].append(dict(w=w / ly["k"] ** 0.5))
    return out


def uniform_pool(batches: int, batch: int, io: dict, seed: int,
                 device) -> torch.Tensor:
    """(batches, batch, H, W, Cin) int32 pixels, uniform in [0, 2**bits)."""
    g = generator(seed, "pool", device)
    return torch.randint(0, 2 ** io["bits"],
                         (batches, batch, io["h"], io["w"], io["cin"]),
                         generator=g, device=device, dtype=torch.int32)


def video_pool(ticks: int, streams: int, io: dict, seed: int, device, *,
               change_rate: float, patch: int = 4
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An always-on camera trace as a cycle of ``ticks`` ticks.

    Each tick, exactly ``round(change_rate * streams)`` streams, drawn
    anew, show their background with a ``patch`` x ``patch`` block at a
    fresh uniform position shifted by half the intensity range (mod the
    range, every color); every other stream repeats its previous frame.
    A stream shows the block of its latest change, counted around the
    cycle, so tick 0 follows tick ``ticks - 1`` as any tick follows its
    predecessor; a stream that never changes shows its bare background.

    Returns ``(frames (ticks, streams, H, W, Cin) int32, changed (ticks,
    streams) bool)``, ``changed[t]`` true where tick t's frame differs
    from tick t - 1's (cyclically).
    """
    h, w, cin, levels = io["h"], io["w"], io["cin"], 2 ** io["bits"]
    g = generator(seed, "video", device)
    bg = torch.randint(0, levels, (streams, h, w, cin), generator=g,
                       device=device, dtype=torch.int32)
    m = int(round(change_rate * streams))
    order = torch.rand((ticks, streams), generator=g,
                       device=device).argsort(dim=1)
    flags = torch.zeros((ticks, streams), dtype=torch.bool, device=device)
    flags.scatter_(1, order[:, :m], True)
    ph, pw = min(patch, h), min(patch, w)
    pos = torch.stack([
        torch.randint(0, h - ph + 1, (ticks, streams), generator=g,
                      device=device),
        torch.randint(0, w - pw + 1, (ticks, streams), generator=g,
                      device=device)], dim=-1)
    # each (tick, stream)'s latest change at or before it, around the cycle
    t_idx = torch.arange(2 * ticks, device=device)[:, None]
    marks = torch.where(flags.repeat(2, 1), t_idx, torch.full_like(t_idx, -1))
    latest = marks.cummax(dim=0).values[ticks:]
    has = latest >= 0
    state = torch.where(has, latest % ticks, torch.zeros_like(latest))
    py = torch.gather(pos[..., 0], 0, state)
    px = torch.gather(pos[..., 1], 0, state)
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    shifted = (bg + levels // 2) % levels
    frames = torch.empty((ticks, streams, h, w, cin), dtype=torch.int32,
                         device=device)
    for t in range(ticks):
        y0, x0 = py[t][:, None, None], px[t][:, None, None]
        inside = ((yy >= y0) & (yy < y0 + ph) & (xx >= x0) & (xx < x0 + pw)
                  & has[t][:, None, None])
        frames[t] = torch.where(inside[..., None], shifted, bg)
    changed = torch.stack([
        (frames[t] != frames[t - 1]).reshape(streams, -1).any(dim=1)
        for t in range(ticks)])
    return frames, changed


def escalation_pool(batches: int, batch: int, io: dict, seed: int, device,
                    *, share: float, candidates: float,
                    margin_of: Callable[[torch.Tensor], torch.Tensor]
                    ) -> Tuple[torch.Tensor, int, Dict[str, float]]:
    """A pool of uniform frames in which exactly ``round(share * batch)``
    frames of every batch reach the escalation threshold, so every seed
    gives every dispatch the same work.

    Draws ``candidates * N`` uniform frames (N the pool's), takes the
    threshold as the margin of the pool's escalating count'th largest of
    their margins (``margin_of``: frames -> integer positive-class
    margins), and fills each batch with its count of frames at or above
    it and the rest below it, in a random order.  Returns ``(pool
    (batches, batch, H, W, Cin), threshold, shares)``, the shares those of
    the pool: escalated, skipped and at the threshold exactly (ties).
    """
    n = batches * batch
    n_cand = int(candidates * n)
    k = int(round(share * batch))
    n_pos = batches * k
    g = generator(seed, "pool", device)
    cand = torch.randint(0, 2 ** io["bits"],
                         (n_cand, io["h"], io["w"], io["cin"]),
                         generator=g, device=device, dtype=torch.int32)
    margin = margin_of(cand)
    ordered = margin.sort(descending=True).values
    threshold = int(ordered[min(n_pos, n_cand) - 1]) if n_pos else (
        int(ordered[0]) + 1)
    pos = torch.nonzero(margin >= threshold)[:, 0]
    neg = torch.nonzero(margin < threshold)[:, 0]
    if pos.numel() < n_pos or neg.numel() < n - n_pos:
        raise ValueError(f"{n_cand} candidates give {pos.numel()} frames at "
                         f"or above margin {threshold} and {neg.numel()} "
                         f"below: too few for {n_pos} and {n - n_pos}")
    pick = torch.cat([pos[:n_pos].reshape(batches, k),
                      neg[:n - n_pos].reshape(batches, batch - k)], dim=1)
    order = torch.rand((batches, batch), generator=g,
                       device=device).argsort(dim=1)
    pick = torch.gather(pick, 1, order).reshape(-1)
    frames = cand[pick]
    chosen = margin[pick]
    shares = {"escalated": float((chosen >= threshold).float().mean()),
              "skipped": float((chosen < threshold).float().mean()),
              "ties": float((chosen == threshold).float().mean())}
    return (frames.reshape(batches, batch, io["h"], io["w"], io["cin"]),
            threshold, shares)
