"""The yardstick's generators and counts: deterministic in the seed, the
video pool's change rate within a binomial spread of the mix's, and the
MAC counts of the configurations exact."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import counts, gen

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
IO = dict(kind="io", h=32, w=32, cin=3, bits=7, channels=256)


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_generators_are_deterministic_in_the_seed():
    seed = 2 ** 31 + 12345
    a = gen.uniform_pool(2, 3, IO, seed, "cpu")
    assert torch.equal(a, gen.uniform_pool(2, 3, IO, seed, "cpu"))
    assert not torch.equal(a, gen.uniform_pool(2, 3, IO, seed + 1, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 128
    v1 = gen.video_pool(8, 16, IO, seed, "cpu", change_rate=0.25)
    v2 = gen.video_pool(8, 16, IO, seed, "cpu", change_rate=0.25)
    assert all(torch.equal(x, y) for x, y in zip(v1, v2))
    layers = _config("cifar9_s1")["stages"][0]["layers"]
    p1 = gen.draw_params(layers, seed, "w", "cpu")
    p2 = gen.draw_params(layers, seed, "w", "cpu")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(p1["conv"], p2["conv"])
               for k in x)
    gammas = torch.cat([p["gamma"] for p in p1["conv"]])
    assert (gammas < 0).any() and (gammas > 0).any()


def test_video_pool_changes_at_the_mix_rate_and_wraps():
    rate, ticks, streams = 0.1, 64, 512
    frames, changed = gen.video_pool(ticks, streams, IO, 99, "cpu",
                                     change_rate=rate)
    n = ticks * streams
    spread = 3 * math.sqrt(n * rate * (1 - rate))
    assert abs(int(changed.sum()) - n * rate) <= spread
    # the wrap: tick 0 against the last tick is a tick like any other
    assert torch.equal(changed[0], (frames[0] != frames[-1]).reshape(
        streams, -1).any(dim=1))
    per_tick = changed.sum(dim=1).float()
    assert abs(float(per_tick[0]) - rate * streams) <= 0.1 * rate * streams
    # a change moves a 4 x 4 block: the old and new blocks' pixels differ
    # (32 less twice their overlap), every color at half the range
    moved = frames[1] != frames[0]
    diff = moved.any(dim=-1).sum(dim=(1, 2))
    assert set(diff.unique().tolist()) <= set(range(0, 33, 2))
    assert torch.equal(moved.any(dim=-1), moved.all(dim=-1))
    half = (frames[1] - frames[0]).abs()[moved]
    assert set(half.unique().tolist()) == {64}


def test_escalation_pool_gives_every_batch_its_share():
    batches, batch, share = 3, 10, 0.3
    seed = 2 ** 31 + 321

    def margin_of(frames):
        return frames.reshape(frames.shape[0], -1).sum(dim=1)

    def pool():
        return gen.escalation_pool(batches, batch, IO, seed, "cpu",
                                   share=share, candidates=1.25,
                                   margin_of=margin_of)

    frames, threshold, shares = pool()
    again, threshold_again, _ = pool()
    assert torch.equal(frames, again) and threshold == threshold_again
    per_batch = (margin_of(frames.reshape(-1, *frames.shape[2:]))
                 .reshape(batches, batch) >= threshold).sum(dim=1)
    assert per_batch.tolist() == [round(share * batch)] * batches
    assert shares["escalated"] == pytest.approx(share)


def test_mac_counts_are_exact():
    c1 = _config("cifar9_s1")
    face = _config("face_cascade")
    layers = {st["program"]: st["layers"]
              for cfg in (c1, face) for st in cfg["stages"]}
    assert counts.macs_per_frame(layers["cifar9_s1"]) == 1_006_643_200
    assert counts.macs_per_frame(layers["face_detector"]) == 62_915_072
    assert counts.macs_per_frame(layers["owner_detector"]) == 1_006_635_008
    for cfg in (c1, face):
        for name, macs in cfg["macs_per_frame"].items():
            assert counts.macs_per_frame(layers[name]) == macs
    assert counts.BINARY_MACS_S == pytest.approx(7.916e15)
    assert counts.frame_bytes(layers["cifar9_s1"]) == 12_288
