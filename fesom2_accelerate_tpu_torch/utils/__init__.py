"""Tools around the port: the kernels' tuning harness (``tuning``), its
command line (``tune``), the ablation of the tiled kernels (``ablate``),
and the bench and its measurement tools (``bench``, ``scaling``,
``accuracy``)."""
