"""Host seconds of the set-up step 'load_s', ended by a device sync;
None in a cell whose set-up has no such step."""

UNIT = "s"


def read(r):
    return r.stages.get("load_s")
