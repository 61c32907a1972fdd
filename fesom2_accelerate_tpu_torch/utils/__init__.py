"""Tools around the port: the kernels' tuning harness (``tuning``) and its
command line (``tune``)."""
