"""`pairs` (x, y) pairs made on the device from the seed, cycled: x and y
independent standard normal float32 volumes, [1, *shape, in_channels] and
[1, *shape, filters], as bench.py draws config #3's batch (a regression of
noise onto noise)."""

import torch

from h100bench.seeds import sub_seed
from h100bench.sources import memory


class Source(memory.Source):
    def rows(self):
        fam, dev = self.cell.family, self.cell.device
        gen = torch.Generator(device=dev).manual_seed(sub_seed(self.cell.seed,
                                                               1))
        out = []
        for _ in range(self.n):
            x = torch.randn((1, *fam.shape, fam.cfg['in_channels']),
                            generator=gen, device=dev)
            y = torch.randn((1, *fam.shape, fam.cfg['head']['filters']),
                            generator=gen, device=dev)
            out.append((x, y))
        return out
