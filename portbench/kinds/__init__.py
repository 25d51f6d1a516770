"""The traffic kinds: ``kinds/<kind>.py`` makes a mix of its kind from the
seed and drives its window. ``run.py`` finds a kind by the name a mix gives
under ``kind``."""
