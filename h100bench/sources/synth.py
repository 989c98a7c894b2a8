"""`pairs` integer label maps and as many sets of synthesis draws, made on
the device from the seed and cycled; the family synthesizes the image
from them inside the step."""

from h100bench.seeds import sub_seed


class Source:
    def __init__(self, cell):
        self.cell = cell
        self.n = int(cell.traffic['pairs'])

    def rows(self):
        fam = self.cell.family
        labels = fam.label_maps(sub_seed(self.cell.seed, 2), self.n)
        return [((lab, fam.draws(sub_seed(self.cell.seed, 3, k))), lab)
                for k, lab in enumerate(labels)]

    def feed(self):
        rows = self.rows()
        while True:
            yield from rows

    def reference_row(self, k):
        return self.rows()[k]

    def close(self):
        pass
