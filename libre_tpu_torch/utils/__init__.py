"""Image encoding (numpy copy of ``libre_tpu.utils.image``)."""
