"""Load drivers: a traffic file names one (``"driver": "files"``), and the
harness imports ``portbench.drivers.<driver>`` and calls its ``run``."""
