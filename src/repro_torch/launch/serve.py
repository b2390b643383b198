"""LM serving: ``python -m repro_torch.launch.serve --arch <id>``.

The counterpart of ``repro.launch.serve``: static-batch serving of one of
the repo's LM configs with random weights from a seed.  A pool of
``--batch`` slots pulls requests from the shared
:class:`repro_torch.serving.queue.FrameQueue`; each pulled batch is
prefilled (attention through the flash-attention kernel on the card),
then decodes ``--gen-len`` tokens greedily (or with ``--temperature``).
The pull size follows the queue's EWMA arrival-rate estimate: each pull
takes what ``--rate`` arrivals should deliver inside half of
``--slo-ms`` (the full ``--batch`` when admission is unpaced).

All timing runs through one injectable monotonic clock (``clock=``,
``sleep=``); the tests drive it with a virtual clock.  Runs on the GPU
unless ``--device cpu``, and eagerly where ``repro`` ``jax.jit``\\ s::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --device cpu --scaled

Every config with an input table serves: attention, MoE (the dense
path: every expert on every token), Mamba and RWKV-6 blocks, and
MusicGen's codebooks (prompts (1, S, ncb), decode fed (B, 1, ncb), each
request's ids the first ``--gen-len`` of its flattened (gen_len, ncb)
output, as ``repro``'s); Jamba at full width needs more than one card,
so only ``--scaled``.  The VLM stub (``embed_inputs=False``) is refused:
this driver's prompts are token ids, which it cannot embed (``repro``'s
launcher fails on them with ``KeyError: 'embeds'``); its embeds serve
through ``train.serve``'s prefill and decode steps.

Beside ``repro``'s per-request and summary lines it prints the prefill
time of each batch and the decode time per token (host clock around
work that ends in a device synchronize).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List

import torch

from repro_torch import device as _device
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data import tokens as dtok
from repro_torch.models import transformer
from repro_torch.serving.queue import FrameQueue, FrameRequest
from repro_torch.train import serve


@dataclasses.dataclass
class ServeReport:
    """What one run served: generated ids by request, in serve order."""
    tokens: Dict[int, List[int]]
    served: int
    seconds: float
    prefill_ms: List[float]          # one per pulled batch
    decode_ms_per_token: List[float]  # one per pulled batch

    @property
    def tokens_per_s(self) -> float:
        n = sum(len(t) for t in self.tokens.values())
        return n / self.seconds if self.seconds > 0 else 0.0


def main(argv=None, *, clock=time.perf_counter, sleep=time.sleep
         ) -> ServeReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--scaled", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="slot count")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="simulated request arrival rate (req/s): paces "
                         "admission so the queue's EWMA rate estimator "
                         "sees realistic gaps (unpaced when omitted)")
    ap.add_argument("--slo-ms", type=float, default=200.0,
                    help="per-request latency SLO the batch sizing "
                         "targets: each pull takes what --rate arrivals "
                         "should deliver within half the SLO")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scaled:
        cfg = cfg.scaled().with_(dtype="float32", param_dtype="float32")
    if not cfg.embed_inputs:
        raise ValueError(
            f"{args.arch} has no input embedding table (embed_inputs=False: "
            f"its vision frontend is a stub fed precomputed patch "
            f"embeddings), and this driver serves token-id prompts; repro's "
            f"launcher feeds it the same and fails with KeyError: 'embeds'. "
            f"Serve its embeds through repro_torch.train.serve's prefill "
            f"and decode steps")
    if cfg.num_codebooks > 1:
        print(f"note: {args.arch} uses a modality stub; serving token IDs")
    dev = _device.resolve(args.device)

    max_len = args.prompt_len + args.gen_len
    params = transformer.init_params(cfg, seed=0, device=dev)
    prefill = serve.build_prefill_step(cfg, max_len=max_len)
    decode = serve.build_decode_step(cfg)

    # one lane per served model; requests are admitted lazily, a batch
    # ahead of the serve loop, with deterministic synthetic prompts
    queue = FrameQueue([args.arch])
    next_rid = 0
    t_start = clock()

    def admit():
        nonlocal next_rid
        while next_rid < args.requests and queue.pending() < args.batch:
            if args.rate:
                # paced admission: request rid arrives at rid/rate; wait
                # for it only when the queue is empty
                due = t_start + next_rid / args.rate
                wait = due - clock()
                if wait > 0:
                    if queue.pending():
                        return
                    sleep(wait)
            prompt = dtok.batch_for_step(cfg, next_rid, global_batch=1,
                                         seq_len=args.prompt_len,
                                         device=dev)["tokens"]
            queue.submit(FrameRequest(rid=next_rid, program=args.arch,
                                      frame=prompt, t_submit=clock()))
            next_rid += 1

    def pull_size() -> int:
        # what the measured arrival rate should deliver inside half the
        # SLO, clamped to the slot pool; full batch until it has a signal
        rate = queue.arrival_rate(args.arch)
        if rate <= 0.0:
            return args.batch
        want = math.ceil(rate * (args.slo_ms / 1e3) * 0.5)
        return max(1, min(want, args.batch))

    report = ServeReport({}, 0, 0.0, [], [])
    gen = torch.Generator(device=dev).manual_seed(42)
    t0 = clock()
    while True:
        admit()
        pulled = queue.next_batch(pull_size())
        if pulled is None:
            break
        _, reqs = pulled
        toks = torch.cat([r.frame for r in reqs])
        pos = torch.arange(args.prompt_len, dtype=torch.int32,
                           device=dev)[None].expand(toks.shape[:2])
        t_pf = clock()
        logits, cache = prefill(params, {"tokens": toks, "positions": pos})
        cur = serve.sample(gen, logits, args.temperature)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_dc = clock()
        outs = [cur]
        for t in range(args.gen_len - 1):
            logits, cache = decode(params, cache, cur, args.prompt_len + t)
            cur = serve.sample(gen, logits, args.temperature)
            outs.append(cur)
        gen_ids = torch.cat(outs, dim=1).cpu()
        t_end = clock()
        report.prefill_ms.append((t_dc - t_pf) * 1e3)
        report.decode_ms_per_token.append(
            (t_end - t_dc) * 1e3 / max(1, args.gen_len - 1))
        for i, r in enumerate(reqs):
            ids = [int(x) for x in gen_ids[i].reshape(-1)[: args.gen_len]]
            report.tokens[r.rid] = ids
            print(f"req {r.rid}: {ids[:12]}...")
        report.served += len(reqs)
    report.seconds = clock() - t0
    n_tok = report.served * args.gen_len
    for i, (pf, dc) in enumerate(zip(report.prefill_ms,
                                     report.decode_ms_per_token)):
        print(f"batch {i}: prefill {pf:.3f} ms, decode {dc:.3f} ms/token")
    print(f"\n{report.served} requests, {n_tok} tokens in "
          f"{report.seconds:.1f}s ({report.tokens_per_s:.1f} tok/s on "
          f"{dev.type})")
    return report


if __name__ == "__main__":
    main()
