"""The benchmark's plain reference: what decides a run's ``correct``.

It reads the same query file and genome the program reads and works
out again, in plain NumPy and PyTorch, what the program derived from
them: the profiles' probability tables (``hmmfile``, ``profile``), the
six-frame translation that the device stages' items must come from
(``translate``), the Forward-parser scores and the domain decoding of
those items (``dp``), and the embedded copies that the reported hits
must cover (``hits``).  It imports nothing of the program.
"""
