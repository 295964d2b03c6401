"""Output writers of the port (its copy of ``aztotmd_tpu/output``)."""
