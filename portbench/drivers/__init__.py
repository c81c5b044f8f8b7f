"""One module per kind of traffic, named by a mix's ``driver`` key. Each
has ``run(ctx) -> record``: set-up, the measured window, and the check of
what the window produced against the reference."""
