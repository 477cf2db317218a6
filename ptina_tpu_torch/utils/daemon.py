'''
Single-thread execution shim for embedding in multi-threaded hosts.

Reference: ptina_tpu/utils/daemon.py (itself the counterpart of ptina's
DaemonModule / DaemonThread / OnDemandProxy, ptina/tools/mtworker.py:
22-89).  Pure Python, copied with its behaviour: host applications (a
Blender add-on, a viewer) serialise every render call onto one worker
thread, so film updates stay ordered and no call mutates the scene under
another.  One CUDA context serves every thread, so nothing here is about
the device.

`DaemonModule(mod)` proxies attribute access: `DaemonModule(worker).render()`
enqueues the call on the daemon thread and blocks for the result.
Exceptions reach the caller (ptina's swallows them and returns None,
mtworker.py:31-37).
'''

import queue
import threading

__all__ = ['DaemonModule', 'DaemonThread', 'OnDemandProxy']


class DaemonThread:
    '''A dedicated worker thread running queued thunks in order.'''

    def __init__(self, name='ptina-worker'):
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box['result'] = fn()
            except BaseException as e:  # noqa: BLE001 — reraised at call site
                box['error'] = e
            done.set()

    def call(self, fn):
        '''Run fn() on the daemon thread, block for and return its result.'''
        if threading.current_thread() is self._thread:
            return fn()  # re-entrant call from the worker itself
        box = {}
        done = threading.Event()
        self._q.put((fn, box, done))
        done.wait()
        if 'error' in box:
            raise box['error']
        return box.get('result')

    def submit(self, fn):
        '''Fire-and-forget (async) variant.'''
        self._q.put((fn, {}, threading.Event()))

    def stop(self):
        self._q.put(None)
        self._thread.join()


class DaemonModule:
    '''Proxy every function attribute of `mod` onto one daemon thread
    (reference mtworker.py:39-42,53-72).'''

    def __init__(self, mod, name=None):
        self._mod = mod
        self._daemon = DaemonThread(name or f'daemon:{getattr(mod, "__name__", mod)}')

    def __getattr__(self, key):
        attr = getattr(self._mod, key)
        if not callable(attr):
            return attr

        def proxy(*args, **kwargs):
            return self._daemon.call(lambda: attr(*args, **kwargs))

        proxy.__name__ = getattr(attr, '__name__', key)
        return proxy

    def stop(self):
        self._daemon.stop()


class OnDemandProxy:
    '''Lazy construction wrapper (reference mtworker.py:75-89): the
    factory runs on first attribute access.'''

    def __init__(self, factory):
        self._factory = factory
        self._obj = None

    def __getattr__(self, key):
        if self._obj is None:
            self._obj = self._factory()
        return getattr(self._obj, key)
