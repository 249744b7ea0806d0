"""The repo's examples (``examples/*.py``) on the port, one module each,
with the same file names, public functions and defaults; each ``main``
(and the functions it calls) also takes ``device``, and runs on the card
unless ``device="cpu"`` is given.  Run one as a script with

    python -m tensornetwork_tpu_torch.examples.<name>

The package imports none of them: ``distributed_symmetric_dmrg`` starts a
process group, ``image_classifier`` needs scipy.
"""
