"""`pairs` (image, one-hot label map) pairs made on the device from the
seed, cycled: an image of the label map (label / L) plus noise, over
labels in smooth regions (the argmax of L smooth random fields)."""

import torch
import torch.nn.functional as F

from h100bench.seeds import sub_seed


class Source:
    def __init__(self, cell):
        self.cell = cell
        self.n = int(cell.traffic['pairs'])

    def rows(self):
        fam, dev = self.cell.family, self.cell.device
        L = fam.cfg['nb_labels']
        gen = torch.Generator(device=dev).manual_seed(sub_seed(self.cell.seed,
                                                               1))
        coarse = [max(s // 16, 2) for s in fam.shape]
        out = []
        for _ in range(self.n):
            f = torch.randn((1, L, *coarse), generator=gen, device=dev)
            lab = F.interpolate(f, size=fam.shape, mode='trilinear',
                                align_corners=True).argmax(1)
            noise = torch.randn((1, *fam.shape), generator=gen, device=dev)
            x = (lab.to(torch.float32) / L + 0.3 * noise)[..., None]
            y = F.one_hot(lab, L).to(torch.float32)
            out.append((x, y))
        return out

    def feed(self):
        rows = self.rows()
        while True:
            yield from rows

    def reference_row(self, k):
        return self.rows()[k]

    def close(self):
        pass
