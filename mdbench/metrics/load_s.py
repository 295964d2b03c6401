"""Seconds ``load_deck_dir`` takes to parse the deck and build the state
on the card: the harness's own span around the call."""

META = {"unit": "s", "better": "lower", "source": "host_clock",
        "layer": "setup", "moves": "setup_s", "workloads": None}


def read(ctx):
    return ctx.load_s
