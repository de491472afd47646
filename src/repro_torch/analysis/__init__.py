"""Host-side analysis: static plan verification (``verifier``, a
numpy-only copy of :mod:`repro.analysis.verifier`) and the port's
repo-specific lints (``lints``).

Submodules are imported explicitly (``from repro_torch.analysis import
verifier``) so the verifier stays importable from hot paths without
side effects.
"""
