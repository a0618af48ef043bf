"""Traffic kinds: each module turns a cell's parameters and the seed into
the requests of one closed-loop client (``requests``)."""
