from .api import init_ndtimers, flush, wait, inc_step, ndtimeit, ndtimer
from .timer import NDTimerManager, Span
from .world_info import WorldInfo
from .handlers import ChromeTraceHandler, LoggingHandler, LocalRawHandler
from .streamer import NDtimelineStreamer, SockHandler
from . import predefined
