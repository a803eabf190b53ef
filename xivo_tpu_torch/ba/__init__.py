"""Bundle adjustment (port of ``xivo_tpu/ba``)."""
