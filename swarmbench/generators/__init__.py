"""Traffic generators, one file each, found by the name a traffic file gives."""
