"""Device ms a volume of the events launched inside the program's spans
around the UNet's glue: 'neurite/unet/cast' (each conv's casts of its
input, weight and bias to bfloat16), 'neurite/unet/upsample' and
'neurite/unet/concat' (each decoder level's upsampling and skip
concatenation). Serving runs the forward only, so every launch of the
glue lies inside its span."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'unet/cast', 'unet/upsample', 'unet/concat')
