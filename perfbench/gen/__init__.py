"""Traffic generators: ``gen/<kind>.py`` reads a mix file whose ``kind``
names it and returns the seeded requests (``perfbench.draw.Request``)."""
