"""Flight-recorder event kinds.

Every record the `FlightRecorder` holds is `(ts, kind, payload)`: a virtual-
clock timestamp, one of the integer kinds below, and a payload dict whose
shape is fixed per kind (documented in docs/OBSERVABILITY.md). Kinds are
plain ints so the recorder can keep them in a preallocated int16 array;
`KIND_NAMES` maps them back for rendering.

Payload identity rules: slices and application batches appear only as the
recorder's *dense interned ids* (`FlightRecorder.sid` / `FlightRecorder.bid`,
assigned in first-seen order along the virtual clock), never as the raw
process-global `slice_id`/`batch_id` counters — those counters keep running
across runs in one process, and the exported trace must be byte-identical
for the same spec + seed no matter how many runs came before.
"""
from __future__ import annotations

INTENT = 1        # a declarative batch was submitted (one per submit_transfer)
WAVE = 2          # one vectorized wave chosen (with full decision provenance)
POST = 3          # one scalar-path slice posted (retry / hop / substitution)
COMPLETE = 4      # a run of slice completions drained (one per drain batch)
FAIL = 5          # one slice's wire operation failed
SUBSTITUTE = 6    # a transfer's whole backend was substituted
BATCH_DONE = 7    # an application batch completed
BATCH_FAIL = 8    # an application batch surfaced a failure
EXCLUDE = 9       # a rail was soft-excluded (implicit or explicit)
READMIT = 10      # an excluded rail was re-admitted (blind or probe-verified)
LINK_FAIL = 11    # a scheduled link failure fired on the fabric
DEGRADE = 12      # a degradation window was installed on a link
RUMOR_SENT = 13   # membership gossiped an exclusion/readmission rumor
RUMOR_RECV = 14   # a peer applied a rumor to its local health state
ANTI_ENTROPY = 15 # one anti-entropy reconciliation round ran
ENGINE_JOIN = 16  # an engine joined the running cluster
ENGINE_LEAVE = 17 # an engine left the running cluster
PHASE = 18        # a serving request finished one phase (span: t0 -> ts)

KIND_NAMES = {
    INTENT: "intent",
    WAVE: "wave",
    POST: "post",
    COMPLETE: "complete",
    FAIL: "fail",
    SUBSTITUTE: "substitute",
    BATCH_DONE: "batch_done",
    BATCH_FAIL: "batch_fail",
    EXCLUDE: "exclude",
    READMIT: "readmit",
    LINK_FAIL: "link_fail",
    DEGRADE: "degrade",
    RUMOR_SENT: "rumor_sent",
    RUMOR_RECV: "rumor_recv",
    ANTI_ENTROPY: "anti_entropy",
    ENGINE_JOIN: "engine_join",
    ENGINE_LEAVE: "engine_leave",
    PHASE: "phase",
}
