"""One driver a kind of entry (`sample`, `train`, `serve`): a traffic file
names its driver, and `run.py` loads `drivers/<driver>.py` and calls its
`run(spec)`."""
