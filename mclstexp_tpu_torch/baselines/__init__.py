"""The baseline families of the port: HisToGene, Hist2ST and THItoGene (slide
level) and BLEEP (per spot) (``models``, ``layers``, ``losses``, ``graph``,
``trainer``, ``super_resolution``, ``torch_import``). Port of
``mclstexp_tpu/baselines``."""
