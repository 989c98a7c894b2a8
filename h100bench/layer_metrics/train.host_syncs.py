"""`program_spans.host_syncs`: the synchronising calls a step inside the
program's span 'neurite/train/step' of the flagship's step: host waits
for the device (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize) and copies to or from pageable host memory."""

from h100bench.program_spans import host_syncs as read  # noqa: F401
