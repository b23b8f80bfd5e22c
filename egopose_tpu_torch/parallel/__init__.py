"""The parallel runtime (counterpart of egopose_tpu/parallel/): ranks and
their mesh (mesh.py), the time-sharded context encode (seqpar.py), the
collective audit (audit.py) and the multi-rank dry run (dryrun.py)."""
