"""Forward FLOPs of every patch of a volume (2 k^3 C_in C_out per output
voxel of each conv, 2 C_in C_out per voxel of each 1x1) over a request's
mean service time in the timed window (from the start of its serving to
its prediction complete), as a share of the chip's peak at the convs'
type, in %."""

from h100bench.reference import quilt


def read(r):
    fam, t = r.cell.family, r.cell.traffic
    patches = 1
    for n, p in zip(t['size'], fam.shape):
        patches *= len(quilt.patch_starts(n, p, t['stride']))
    peak = r.peaks[f'{fam.peak_key()}_flop_per_s']
    return 100 * fam.forward_flops() * patches / r.untraced['service_s'] / peak
