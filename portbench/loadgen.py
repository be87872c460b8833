"""The load generator: a process of its own that sends a run's requests
to a model server's ``/generate`` on its schedule and times what comes
back.

Run as ``python3 portbench/loadgen.py`` with one JSON object on standard
input: ``port``, ``traffic`` (the mix's file contents), ``rate``,
``seconds``, ``seed``, ``vocab``, ``window_start`` (a
``time.monotonic()`` reading, which every process of the machine shares)
and ``grace`` (seconds past the window's close to wait for its
requests). It prints one JSON object: each request's ``id``, ``due``,
``sent``, the arrival time of each streamed token (``times``), the
tokens, whether it is ``counted`` and its ``error``, if any. Times are
monotonic seconds. The open loop sends each request when it is due,
whatever the server has answered; one thread a request.
"""
import http.client
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.generators import open_loop  # noqa: E402  pylint: disable=wrong-import-position


def stream(port: int, req: dict, timeout: float) -> dict:
    """Send one request at its due time and read its token events."""
    out = {'id': req['id'], 'due': req['due'], 'counted': req['counted'],
           'prompt_len': len(req['prompt']),
           'max_new_tokens': req['max_new_tokens'], 'times': [],
           'tokens': [], 'error': None, 'sent': None}
    delay = req['due'] - time.monotonic()
    if delay > 0:
        time.sleep(delay)
    body = json.dumps({'prompt': req['prompt'],
                       'max_new_tokens': req['max_new_tokens'],
                       'stream': True}).encode()
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        out['sent'] = time.monotonic()
        conn.request('POST', '/generate', body=body,
                     headers={'Content-Type': 'application/json',
                              'X-Request-Id': req['id']})
        resp = conn.getresponse()
        if resp.status != 200:
            out['error'] = f'http {resp.status}'
            return out
        while True:
            line = resp.readline()
            if not line:
                out['error'] = 'stream ended before its last token'
                return out
            if not line.startswith(b'data: '):
                continue
            event = json.loads(line[6:])
            if 'error' in event:
                out['error'] = str(event['error'])
                return out
            out['times'].append(time.monotonic())
            out['tokens'].append(int(event['token']))
            if event.get('done'):
                return out
    except (OSError, http.client.HTTPException, ValueError) as e:
        out['error'] = f'{type(e).__name__}: {e}'
        return out
    finally:
        conn.close()


def main() -> None:
    args = json.loads(sys.stdin.read())
    start = args['window_start']
    reqs = open_loop.schedule(args['traffic'], args['rate'],
                              args['seconds'], args['seed'], args['vocab'])
    for r in reqs:
        r['due'] += start
    deadline = start + args['seconds'] + args['grace']
    results = [None] * len(reqs)
    threads = []

    def run(i, req):
        results[i] = stream(args['port'], req,
                            max(1.0, deadline - req['due']))

    for i, req in enumerate(reqs):
        # Start each thread a little ahead of its due time; it sleeps
        # the rest, so a slow thread start never delays a send.
        lead = req['due'] - 0.05 - time.monotonic()
        if lead > 0:
            time.sleep(lead)
        t = threading.Thread(target=run, args=(i, req), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    out = []
    for req, res in zip(reqs, results):
        if res is None:
            res = {'id': req['id'], 'due': req['due'],
                   'counted': req['counted'],
                   'prompt_len': len(req['prompt']),
                   'max_new_tokens': req['max_new_tokens'], 'times': [],
                   'tokens': [], 'sent': None,
                   'error': 'no answer within the grace period'}
        else:
            res = dict(res, times=list(res['times']),
                       tokens=list(res['tokens']))
        out.append(res)
    sys.stdout.write(json.dumps({'requests': out}))
    sys.stdout.flush()


if __name__ == '__main__':
    main()
