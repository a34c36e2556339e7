"""The test-sized preset of each configuration added after ``tests/tiny.py``
was written, registered with it before any test runs, so that every test
that walks the manifest's cells (``tests/test_harness_check.py``) finds one."""

from benchmark.tests import tiny

# The program builds Hist2ST's widths from the image's side and the family's
# defaults: 28-px images give a 64-wide model, 16 heads of 64, an MLP of 64.
HIST2ST = {"n_genes": 8, "patch_size": 28, "dim": 64, "mlp_dim": 64, "bucket": 16}

tiny.CONFIGS.setdefault("hist2st", HIST2ST)
