"""The slide-level baseline families of the port: HisToGene and THItoGene
(``models``, ``layers``, ``graph``, ``trainer``). Port of
``mclstexp_tpu/baselines``; Hist2ST and BLEEP are still to port."""
