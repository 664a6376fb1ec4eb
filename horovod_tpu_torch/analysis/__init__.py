"""Runtime analysis of the port: the collective fingerprint verifier
(analysis/verifier.py). The static analyzers are ROADMAP A15."""
