"""Spill-priority policy constants (port of
spark_rapids_tpu/memory/spill_priorities.py; reference
`SpillPriorities.scala`):
lower priority spills first.  Shuffle output written early in a stage is the
best candidate (likely not needed again soon on this device); actively-used
operator intermediates spill last.
"""

# shuffle map output: spill first, ascending with write order so the
# oldest-written partitions go before fresher ones
OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY = -1e9

# broadcast build tables are reread by every stream batch: keep on device
BROADCAST_PRIORITY = 1e9

# operator intermediates default to neutral
ACTIVE_BATCH_PRIORITY = 0.0

# received shuffle blocks about to be read
INPUT_FROM_SHUFFLE_PRIORITY = -1e8


def shuffle_output_priority(seq: int) -> float:
    """Monotonic priority for successive shuffle writes."""
    return OUTPUT_FOR_SHUFFLE_INITIAL_PRIORITY + seq
