"""The serving cell's client: one researcher clicking, in a process of its
own (the standard library only), sending ``POST /top_features`` with a
multipart upload and waiting for each answer before the next (a closed
loop).

    python3 serve_client.py <port> <top_n> <upload.wav>...

Commands arrive on standard input, one a line; each answer is one JSON
line on standard output:

* ``run <n> <seconds> <first>``: send requests until ``n`` have been sent
  (``n`` > 0) or ``seconds`` have passed (``n`` = 0), the uploads in turn
  from ``first``; → {"requests": [[upload, seconds, status], ...], "s": span}
* ``bodies <i> <j> ...``: → {"bodies": {i: body}} of this process's
  requests i, j, … (numbered from 0 over every ``run``)
* ``quit``
"""

import http.client
import json
import sys
import time


def multipart(path: str) -> tuple[bytes, str]:
    boundary = "portbench-boundary-7d3f1c"
    with open(path, "rb") as f:
        audio = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"audio\"; "
            f"filename=\"upload.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
        + audio + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def main() -> None:
    port, top_n, paths = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3:]
    uploads = [multipart(p) for p in paths]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    bodies = []
    for line in sys.stdin:
        cmd = line.split()
        if not cmd or cmd[0] == "quit":
            break
        if cmd[0] == "bodies":
            out = {i: bodies[int(i)] for i in cmd[1:]}
            print(json.dumps({"bodies": out}), flush=True)
            continue
        n, seconds, nxt = int(cmd[1]), float(cmd[2]), int(cmd[3])
        done = []
        t0 = time.perf_counter()
        while (len(done) < n) if n > 0 else (time.perf_counter() - t0 < seconds):
            u = nxt % len(uploads)
            nxt += 1
            body, ctype = uploads[u]
            t = time.perf_counter()
            try:
                conn.request("POST", f"/top_features?top_n={top_n}", body=body,
                             headers={"Content-Type": ctype})
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                data, status = b"", 0
            done.append([u, time.perf_counter() - t, status])
            bodies.append(data.decode("utf-8", "replace") if status == 200 else "")
        print(json.dumps({"requests": done, "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
