"""
Serving traffic: whole volumes segmented patch by patch through the
program's `utils.seg.predict_volume_device`, one request at a time.

Each request hands in a host float32 volume [*size, 1] (so its copy to
the card is in the request) and ends when its prediction is complete on
the card (a synchronise). Requests are due at a fixed rate
(`rate_per_s`, one every 1 / rate seconds from the window's start: an
open loop); a request's latency runs from when it was due. The window
holds the requests due in its first `seconds`; each is served, late or
not. The traced window serves `trace_requests` at the same rate.

`volumes` host volumes are made from the seed and cycled. The served
probabilities of `check_requests` requests of the window, drawn from the
seed, are kept and compared after the window with the plain reference's
float32 overlap mean over the same patches.
"""

import contextlib
import math
import time

import numpy as np
import torch

from h100bench import trace
from h100bench.reference import quilt
from h100bench.seeds import sub_seed


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.size = tuple(t['size'])
        self.patch = tuple(cell.family.shape)
        self.stride = int(t['stride'])
        self.rate = t['rate_per_s']
        self.n_vols = int(t['volumes'])
        self.n_check = int(t['check_requests'])
        self.trace_requests = int(t['trace_requests'])
        self.attempted = 0

    def volumes(self):
        """The host volumes: a smooth random field plus noise, made on the
        device from the seed and copied to pageable host memory."""
        dev = self.cell.device
        gen = torch.Generator(device=dev).manual_seed(sub_seed(self.cell.seed,
                                                               5))
        out = []
        for _ in range(self.n_vols):
            f = torch.randn((1, 1, *[max(s // 16, 2) for s in self.size]),
                            generator=gen, device=dev)
            v = torch.nn.functional.interpolate(f, size=self.size,
                                                mode='trilinear',
                                                align_corners=True)[0, 0]
            v = v + 0.2 * torch.randn(self.size, generator=gen, device=dev)
            out.append(v[..., None].cpu().numpy())
        return out

    def setup(self):
        cell, nt = self.cell, self.cell.nt
        fam = cell.family
        self.model = fam.program(nt, fam.weights(cell.weight_seed))
        self.vols = self.volumes()
        self.predict = nt.utils.seg.predict_volume_device
        cell.mark('inputs and model')
        for v in self.vols[:2]:
            self.serve(v)
        cell.sync()
        cell.mark('two volumes served (warm-up)')
        self.kept = {}

    def serve(self, vol):
        return self.predict(self.model, vol, self.patch, stride=self.stride,
                            agg='mean', device=self.cell.device)

    # --- windows ------------------------------------------------------------

    def requests(self, n, keep=(), spans=False):
        """Serve `n` requests due one every 1 / rate s from now, keeping
        the predictions of those in `keep`; (latencies, service times,
        wall), in s."""
        lat, service = [], []
        t0 = time.perf_counter()
        for i in range(n):
            due = t0 + i / self.rate
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            start = time.perf_counter()
            with trace.span('request') if spans else contextlib.nullcontext():
                out = self.serve(self.vols[i % self.n_vols])
                self.cell.sync()
            done = time.perf_counter()
            lat.append(done - due)
            service.append(done - start)
            if i in keep:
                self.kept[i] = out
        self.attempted += n
        return lat, service, time.perf_counter() - t0

    def window(self, seconds):
        n = math.ceil(seconds * self.rate)
        rng = np.random.default_rng(sub_seed(self.cell.seed, 6))
        keep = set(rng.choice(n, min(self.n_check, n), replace=False)
                   .tolist())
        lat, service, wall = self.requests(n, keep)
        # served over wall time: the rate due below the knee, the rate
        # sustained above it
        return {'serve_vol_per_s': n / wall,
                'serve_ms_p95': 1e3 * float(np.percentile(lat, 95)),
                'service_s': float(np.mean(service))}

    def traced_window(self):
        """`trace_requests` requests at the cell's rate under the profiler,
        a 'request' span around each and the family's forward hooks on;
        (trace, requests, {})."""
        out = {}
        hooks = self.cell.family.span_hooks(self.model, serve=True)
        with trace.profiled(out):
            with trace.span('window'):
                self.requests(self.trace_requests, spans=True)
        for h in hooks:
            h.remove()
        return out['trace'], self.trace_requests, {}

    # --- the check ----------------------------------------------------------

    def free(self):
        self.kept = {i: v.to('cpu') for i, v in self.kept.items()}
        del self.model

    def reference(self, precision='f32'):
        """{request: float32 prediction} of the reference on the kept
        requests' volumes (on the card, one volume at a time)."""
        fam = self.cell.family
        w = fam.weights(self.cell.weight_seed)
        flags = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = {}
            with torch.no_grad():
                for i in sorted(self.kept):
                    vol = torch.from_numpy(self.vols[i % self.n_vols]).to(
                        self.cell.device)
                    out[i] = quilt.predict(
                        lambda p: fam.reference_forward(w, p, precision), vol,
                        self.patch, self.stride).cpu()
            return out
        finally:
            torch.backends.cudnn.allow_tf32 = flags

    def numbers(self, ref):
        gaps = [float((self.kept[i].to(torch.float32) - ref[i]).abs().max())
                for i in ref]
        return {'prob_gap': max(gaps) if gaps else float('nan')}
