"""One module a kind of traffic, named by a traffic file's ``driver``:
``setup(ctx)`` makes the inputs, builds and warms the program and returns
an object with ``step()`` (one model step, without the synchronize),
``checks(control=False)`` ([(name, value, limit)] against the reference,
after the window) and ``bytes_per_step`` (the contract bytes of a model
step, or None)."""
