"""The jobs the benchmark times, one module an entry point of the
program; a configuration names its entry (``"entry"``)."""
