"""Device ms a step of the events launched inside the program's spans
'neurite/synth/perlin' and 'neurite/synth/apply': the SynthStrip step's
synthesis (Perlin fields, the K4 warps, the K6 blur, the intensities),
the quantity `synth.ms` reads between the harness's forward hooks, here
from the program's own spans."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'synth/perlin', 'synth/apply')
