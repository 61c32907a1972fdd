"""Run-time helpers of the port: bytes-moved models and kernel bounds
(``profiling``), device timing and the profiler (``tracing``), the
on-device ``run`` as CUDA graphs (``graphs``) and checkpoints
(``checkpoint``)."""
