"""One module per model class, ``<model_class>.py``, named letter for letter
as a configuration's ``model_class`` (``core.model_module`` finds it)."""
