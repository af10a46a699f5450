"""Plain references, one file each, found by the name a configuration gives."""
