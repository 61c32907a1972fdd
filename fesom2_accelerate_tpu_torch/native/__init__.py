"""The port's host-embedding C ABI (``fesom2_torch_host.cpp``, the
``f2t_*_`` surface over ``host_embed``), its demo host
(``host_embed_demo.cpp``), their g++ build (``build``) and what runs
the demo on a case (``demo``).  Importing this package compiles nothing."""
