"""Host seconds of the set-up step 'union_build_s', ended by a device sync;
None in a cell whose set-up has no such step."""

UNIT = "s"


def read(r):
    return r.stages.get("union_build_s")
