"""Memory subsystems: Memdir (Maildir-style file store + HTTP API) and
Memorychain (distributed memory/task ledger). Capability parity with the
reference's memdir_tools package (SURVEY.md §2.2).

A copy of ``fei_tpu/memory/__init__.py`` that imports only the port.
"""
