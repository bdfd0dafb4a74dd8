"""plane_copy_device_ms: device ms a call of the work launched with
``planes.split`` or ``planes.join`` as the innermost program span: the
copies that split columns into int32 word planes around a sort or
partition and join them back (``ops/stream.py``), in the stretch with the
program's spans on.  None where the program recorded no such span."""

from portbench import spans


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    return spans.device_ms_in(st, ("planes.split", "planes.join"))
