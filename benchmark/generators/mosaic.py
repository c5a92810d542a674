"""Seeded haplotype panels and queries, drawn on the device.

Each haplotype is a mosaic of founders (the recipe of ``chip_smoke.py``'s
``ls_panel`` and of its imputation panel): founder site frequencies are
beta(0.2, 0.8), a haplotype copies one founder and switches to a founder
drawn afresh with a fixed rate at each site, and allele noise flips each
allele with a fixed rate on top. Queries are fresh mosaics of the same
founders with their own switches and noise: target samples of the panel's
population, not copies of its rows.

Every draw comes from a ``torch.Generator`` on the target device, seeded
from ``--seed`` and a stream name (:func:`generator`), in large calls; the
same seed gives the same bits on the same device, and a stream can be drawn
again alone (a batch of queries, the panel) after the window, for the
reference.
"""

from __future__ import annotations

import hashlib

import torch

# rows of a mosaic drawn at a time: bounds the temporaries (about 25 bytes an
# element) whatever the panel's size; fixed, so that every draw of a stream
# cuts it alike
CHUNK_ELEMENTS = 1 << 27
# Johnk's rejection rounds for beta(0.2, 0.8): each accepts with p = 0.855
BETA_ROUNDS = 16


def stream_seed(seed: int, *names: str) -> int:
    """A 63-bit seed for the stream ``names`` of run seed ``seed``."""
    key = ":".join((str(int(seed)),) + names).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int, *names: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *names))
    return g


def beta_02_08(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n draws of beta(0.2, 0.8) in f64 by Johnk's method: X = U^5,
    Y = V^1.25, accepted when X + Y <= 1, the value X / (X + Y); the first
    of BETA_ROUNDS rounds that accepts."""
    u, v = (torch.rand((BETA_ROUNDS, n), generator=gen, device=device,
                       dtype=torch.float64) for _ in "uv")
    x, y = u.pow(1 / 0.2), v.pow(1 / 0.8)
    s = x + y
    ok = (s <= 1) & (s > 0)
    first = ok.to(torch.uint8).argmax(0, keepdim=True)
    return torch.nan_to_num((x / s).gather(0, first)[0], nan=0.5)


class Founders:
    """The founder haplotypes of a configuration's population: (K, N)
    uint8 on ``device``, with the switch and noise rates of its
    mosaics."""

    def __init__(self, cfg: dict, seed: int, device):
        a = cfg["assumed"]
        self.device = torch.device(device)
        self.switch, self.noise = float(a["switch_rate"]), float(a["noise_rate"])
        self.seed = seed
        n = int(cfg["sites"])
        gen = generator(self.device, seed, "founders")
        freqs = beta_02_08(n, gen, self.device)
        self.F = (torch.rand((int(a["founders"]), n), generator=gen,
                             device=self.device, dtype=torch.float64)
                  < freqs).to(torch.uint8)

    def mosaics(self, rows: int, *stream: str) -> torch.Tensor:
        """(rows, N) uint8 mosaics of stream ``stream``."""
        F, dev = self.F, self.device
        K, N = F.shape
        gen = generator(dev, self.seed, *stream)
        out = torch.empty((rows, N), dtype=torch.uint8, device=dev)
        site = torch.arange(N, device=dev)
        step = max(1, CHUNK_ELEMENTS // max(N, 1))
        for r0 in range(0, rows, step):
            r = min(step, rows - r0)
            switched = torch.rand((r, N), generator=gen, device=dev) < self.switch
            switched[:, 0] = True
            new = torch.randint(K, (r, N), generator=gen, device=dev,
                                dtype=torch.int16)
            # the founder drawn at the last switch at or before each site
            last = torch.where(switched, site, 0).cummax(1).values
            src = new.gather(1, last).long()
            x = F.view(-1)[src * N + site]
            flip = torch.rand((r, N), generator=gen, device=dev) < self.noise
            out[r0:r0 + r] = x ^ flip.to(torch.uint8)
        return out

    def panel(self, rows: int) -> torch.Tensor:
        """The (rows, N) panel."""
        return self.mosaics(rows, "panel")

    def queries(self, rows: int, batch: int) -> torch.Tensor:
        """Batch ``batch`` of queries, (rows, N)."""
        return self.mosaics(rows, "queries", str(batch))
