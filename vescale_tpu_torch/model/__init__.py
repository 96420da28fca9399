"""Module-form wrappers of the port (the counterpart of ``vescale_tpu.model``)."""
