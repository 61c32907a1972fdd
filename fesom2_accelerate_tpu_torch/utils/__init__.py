"""Tools around the port: the kernels' tuning harness (``tuning``), its
command line (``tune``), and the ablation of the tiled kernels
(``ablate``)."""
