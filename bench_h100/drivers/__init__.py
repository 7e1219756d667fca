"""One driver per kind of system a configuration deploys (its
``system`` key): set-up, warm-up, the measured window and the check of
what the window produced."""
