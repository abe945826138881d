"""Offline label generation: a raw sensor tree in, every label family the
CODa reader reads out.

Counterpart of ``creste_public_tpu/preprocessing`` (the reference's
scripts/preprocessing stack, SURVEY §2.5). The numeric work (the depth
z-buffer, IDW infill, elevation binning and gap scan, DBSCAN, PCA) runs in
torch on an explicit ``device`` that defaults to ``cuda``; file I/O, pose
chains and the split logic stay NumPy on the host. Each entry point of
``scripts/preprocessing`` is a module here, run as ``python -m
creste_public_tpu_torch.preprocessing.<name>`` with the same arguments and
``--device``.
"""
