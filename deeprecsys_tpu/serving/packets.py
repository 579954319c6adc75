"""Request/response packets.

Reference: ``utils/packets.py`` — ``ServiceRequest`` carries
(batch_id, epoch, arrival_time, batch_size, sub_id, total_sub_batches,
exp_packet); ``ServiceResponse`` adds consumer id, queue/inference
timestamps and the measured output batch size. ``exp_packet`` marks
warm-up/tuning traffic excluded from final metrics
(``DeepRecSys.py:128-129``).

Slotted dataclasses: these packets cross queues millions of times per run;
fixed layout also maps 1:1 onto the native shared-memory ring buffer in
``deeprecsys_tpu/runtime`` (a packet is plain ints/floats/bools).
"""

from __future__ import annotations

import dataclasses


# Response error codes (an addition; the reference has no
# per-request error channel — a failed engine just hangs the run,
# SURVEY.md §5). Codes, not strings: they must fit the 64-byte POD ring
# slot (runtime/shm_queue.py) one byte wide.
ERR_OK = 0
ERR_READBACK = 1        # device readback failed after dispatch
ERR_OVER_LADDER = 2     # request exceeds the engine's compiled bucket ladder
ERR_DEADLINE = 3        # deadline expired before dispatch (never executed)
ERR_RELOAD = 4          # checkpoint reload failed (old params keep serving)
ERR_PAYLOAD = 5         # payload shape mismatch vs the engine's model

ERROR_MESSAGES = {
    ERR_OK: None,
    ERR_READBACK: "device readback failed",
    ERR_OVER_LADDER: "request exceeds the engine's compiled bucket ladder",
    ERR_DEADLINE: "deadline expired before dispatch",
    ERR_RELOAD: "checkpoint reload failed; previous params keep serving",
    ERR_PAYLOAD: "payload shape does not match the engine's model",
}

# batch_id marker of a cpu-mp reload ACK response (never a real batch id:
# batch ids count up from 0). consumer_id = the acking engine;
# out_batch_size 1 = applied, 0 = failed (error_code ERR_RELOAD).
RELOAD_ACK_BATCH_ID = -1


@dataclasses.dataclass(slots=True)
class ServiceRequest:
    batch_id: int = 0
    epoch: int = 0
    batch_size: int = 0
    arrival_time: float = 0.0
    sub_id: int = 0
    total_sub_batches: int = 1
    exp_packet: bool = False
    # Absolute deadline (epoch seconds); 0.0 = none. Engines drop expired
    # requests BEFORE dispatch (no device time burnt) and answer with an
    # ERR_DEADLINE response so waiters unblock immediately.
    deadline: float = 0.0
    # Client-supplied features: a models/base.Batch of HOST numpy arrays
    # with exactly ``batch_size`` rows (real-inference path — the engine
    # runs THESE rows and returns their scores in ``ServiceResponse.scores``).
    # None = load-modeling request (the reference's only kind: engines run
    # pre-generated data sliced to batch_size, inferenceEngine.py:200-206).
    # In-process queues only — the 64-byte POD ring raises on payloads.
    payload: object = None
    # cpu-mp transport for the same features: the BlobArena slot holding
    # them (runtime/blob_arena.py). -1 = none. Crosses the POD ring in the
    # request's otherwise-unused consumer_id field; the engine hydrates
    # ``payload`` from the slot and writes the scores back into it.
    payload_slot: int = -1


@dataclasses.dataclass(slots=True)
class ServiceResponse:
    consumer_id: int = 0
    epoch: int = 0
    batch_id: int = 0
    batch_size: int = 0
    arrival_time: float = 0.0
    queue_start_time: float = 0.0
    queue_end_time: float = 0.0
    inference_end_time: float = 0.0
    out_batch_size: int = 0
    sub_id: int = 0
    total_sub_batches: int = 1
    exp_packet: bool = False
    error_code: int = ERR_OK
    # (batch_size, out_dim) float32 numpy scores for THIS request's rows;
    # set only when the request carried a payload. In-process only.
    scores: object = None

    def latency(self) -> float:
        return self.inference_end_time - self.arrival_time

    def error_message(self) -> "str | None":
        return ERROR_MESSAGES.get(self.error_code,
                                  f"engine error {self.error_code}")
