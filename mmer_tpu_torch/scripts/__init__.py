"""The port's scripts: kernel profiles and probes, the training chains, the
data-prep chain and the detector scorer (run with ``python3 -m``)."""
