"""The benchmark's plain reference: its own mesh derivation, the FCT-ALE
step and ``stress2rhs`` in plain PyTorch, and the comparison that decides
``correct``.  Imports neither jax nor anything of the program."""
